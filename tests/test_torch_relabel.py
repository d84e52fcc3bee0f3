"""Auto-RCM operators on the natural views: one launch a call, no gather.

A relabeled ``VBCOperator`` holds ``A[perm][:, perm]``.  Its ``tr_mul``,
``mul``, ``tr_mul_mat`` and ``mul_mat`` run on the packs' natural views
(``natural_view``: rows ``perm[idx]``, output column ``j`` at
``perm[j]``), so the permutation lives in the pack and in the store.  On
the scrambled FEM k=80 grid (relabeled under ``reorder="auto"``) and the
k=40 grid under ``reorder="always"`` each call, with and without
alpha/beta/y, must agree with the JAX operator, with the composed path
it replaces (gather x, the plain kernel on the relabeled pack, gather y,
``beta * y``) and with the f64 product, and call neither ``gather`` nor
``index_select``; ``tr_mul_chain`` neither (its ``perm`` is folded into
the chain kernel, a gather pass before its iterations and one after).
The JAX operator runs its Pallas kernels in interpret mode for the FEM
k=80 ``tr_mul`` with alpha, beta and y (~12 s a call;
``test_torch_operator.py`` holds both operators' ``tr_mul``/``mul`` with
alpha, beta and y against it too) and its XLA route for the rest.

Tolerance: ``|Δ| / max|y| <= 2e-5`` (f32 sums in other orders); the
natural views' coordinates are bitwise those of the relabeled pack
mapped through ``perm``.
"""

import contextlib
import functools
import os
import sys
from unittest import mock

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
import vbcs_tpu_torch.ops.gather as gather_mod
from vbcs_tpu.ops import pallas_trspmv3 as pk3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import fem_matrix  # noqa: E402

TOL = 2e-5
CASES = {"fem80_auto": (80, "auto"), "fem40_always": (40, "always")}
# (case, call) run against the JAX operator's Pallas kernels in interpret
# mode, with alpha, beta and y; the rest against its XLA route
PALLAS = {("fem80_auto", "tr_mul")}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(pk3.pl, "pallas_call", patched)
    yield


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def operators(case):
    """(A, the port's operator, the JAX operator on Pallas, on XLA)."""
    k, reorder = CASES[case]
    A = fem_matrix(k=k).astype(np.float32)
    opt = vt.VBCOperator.from_csc(A, W=8, reorder=reorder, device="cpu")
    opj = v.VBCOperator.from_csc(A, W=8, use_pallas=True, reorder=reorder)
    opx = v.VBCOperator.from_csc(A, W=8, use_pallas=False, reorder=reorder)
    assert opt.row_perm is not None
    np.testing.assert_array_equal(opt.row_perm, opj.row_perm)
    return A, opt, opj, opx


@contextlib.contextmanager
def spy():
    """Counts the gathers (``ops.gather.gather`` runs its plain version on
    a CPU tensor, looked up at each call) and every ``index_select``
    inside the block."""
    calls = {"gather": 0, "index_select": 0}

    def counting(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with contextlib.ExitStack() as stack:
        for owner, name, key in ((gather_mod, "gather_plain", "gather"),
                                 (torch.Tensor, "index_select", "index_select"),
                                 (torch, "index_select", "index_select")):
            stack.enter_context(mock.patch.object(
                owner, name, counting(getattr(owner, name), key)))
        yield calls


def composed(opt, fn, x, alpha=None, beta=None, y=None):
    """The path the natural views replace: gather x into relabeled space,
    the plain kernel on the relabeled pack, gather y out, ``beta * y``."""
    perm, inv = opt.perm_t, torch.argsort(opt.perm_t).int()
    fmt = opt.dev_tr if fn in ("tr_mul", "tr_mul_mat") else opt.dev_fw
    if fn.endswith("_mat"):
        return vt.tr_spmm_plain(fmt, x.index_select(0, perm)).index_select(0, inv)
    out = vt.gather(vt.tr_spmv_plain(fmt, vt.gather(x, perm), alpha), inv)
    return out + beta * y if beta is not None else out


@pytest.mark.parametrize("fn", ["tr_mul", "mul", "tr_mul_mat", "mul_mat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_relabeled_call(case, fn):
    A, opt, opj, opx = operators(case)
    rng = np.random.default_rng(7)
    A64 = A.astype(np.float64)
    n = A.shape[0]
    if fn.endswith("_mat"):
        X = rng.standard_normal((n, 6)).astype(np.float32)
        runs = [((), A64.T @ X if fn == "tr_mul_mat" else A64 @ X)]
    else:
        X = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        prod = A64.T @ X if fn == "tr_mul" else A64 @ X
        runs = [((), prod), ((0.5, -0.25, y), 0.5 * prod - 0.25 * y)]
    for args, want in runs:
        targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        ref = composed(opt, fn, torch.from_numpy(X), *targs).numpy()
        with spy() as calls:
            got = getattr(opt, fn)(torch.from_numpy(X), *targs).numpy()
        assert calls == {"gather": 0, "index_select": 0}, calls
        jax_op = opj if (case, fn) in PALLAS and args else opx
        jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        yj = np.asarray(getattr(jax_op, fn)(jnp.asarray(X), *jargs))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert rel_err(got, yj) <= TOL, (fn, args != ())
        assert rel_err(got, ref) <= TOL, (fn, args != ())
        assert rel_err(got, want) <= TOL, (fn, args != ())


@pytest.mark.parametrize("case", sorted(CASES))
def test_routes_take_natural_views(case):
    """Both routes' formats are natural views (``col_out = perm``): the
    FEM's stripes of ~1.98 take the scatter route; the SpMM's stripe
    views (``nat_tr``/``nat_fw``) share all but ``idx`` and ``col_out``
    with the relabeled packs."""
    _, opt, _, _ = operators(case)
    for route, nat, pack, host in ((opt.route_tr, opt.nat_tr, opt.dev_tr, opt.host_tr),
                                   (opt.route_fw, opt.nat_fw, opt.dev_fw, opt.host_fw)):
        name, fmt, _ = route
        assert name == "scatter" and isinstance(fmt, vt.ScatterDevice)
        relabeled = vt.ScatterDevice.from_host(host, "cpu")
        assert torch.equal(fmt.col_out, opt.perm_t) and relabeled.col_out is None
        assert torch.equal(fmt.row, opt.perm_t.long()[relabeled.row.long()].int())
        assert torch.equal(fmt.colptr, relabeled.colptr)
        assert torch.equal(nat.col_out, opt.perm_t) and pack.col_out is None
        # only idx and col_out are the stripe view's own
        for f in ("spl", "pos", "ofs", "val", "col_stripe"):
            assert getattr(nat, f) is getattr(pack, f)
        assert nat.nbytes - pack.nbytes == 4 * nat.n


@pytest.mark.parametrize("case", sorted(CASES))
def test_tr_mul_chain_still_gathers_twice(case):
    """The chain's two gathers (x in, y out) are folded into it, its
    ``perm`` (the test's name is older than the fold): no gather is
    called, and the result is bitwise the composed gather path's."""
    A, opt, _, _ = operators(case)
    x = np.random.default_rng(8).standard_normal(A.shape[0]).astype(np.float32)
    with spy() as calls:
        got = opt.tr_mul_chain(torch.from_numpy(x), 3, 0.25).numpy()
    assert calls == {"gather": 0, "index_select": 0}, calls
    composed_y = vt.gather(vt.tr_spmv_chain_plain(
        opt.dev_tr, vt.gather(torch.from_numpy(x), opt.perm_t), 3, 0.25),
        torch.argsort(opt.perm_t).int())
    np.testing.assert_array_equal(got, composed_y.numpy())
    want = x.astype(np.float64)
    for _ in range(3):
        want = 0.25 * (A.T.astype(np.float64) @ want)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("which", ["stripe", "scatter"])
def test_natural_view_coords_bitwise(which):
    """The view's (row, col) are the relabeled pack's mapped through perm,
    bitwise; it shares the values."""
    _, opt, _, _ = operators("fem80_auto")
    if which == "stripe":
        pack = opt.dev_tr
    else:
        pack = vt.ScatterDevice.from_host(opt.host_tr, "cpu")
    view = pack.natural_view(opt.perm_t)
    perm = opt.perm_t.long()
    row, col = pack.value_coords
    vrow, vcol = view.value_coords
    assert torch.equal(vrow, perm[row]) and torch.equal(vcol, perm[col])
    assert view.val is pack.val


def test_scatter_route_relabeled():
    """An unstructured square matrix relabeled by auto-RCM: both
    directions on the scatter kernel's natural view, no gather."""
    rng = np.random.default_rng(9)
    n, nnz = 8000, 56000
    A = sp.coo_matrix((rng.standard_normal(nnz).astype(np.float32),
                       (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
                      shape=(n, n)).tocsc()
    A.sum_duplicates()
    opt = vt.VBCOperator.from_csc(A, W=8, reorder="auto", device="cpu")
    assert opt.row_perm is not None
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    A64 = A.astype(np.float64)
    for fn, route, prod in (("tr_mul", opt.route_tr, A64.T @ x),
                            ("mul", opt.route_fw, A64 @ x)):
        assert route[0] == "scatter" and torch.equal(route[1].col_out, opt.perm_t)
        with spy() as calls:
            got = getattr(opt, fn)(torch.from_numpy(x), 2.0, 0.5,
                                   torch.from_numpy(y)).numpy()
        assert calls == {"gather": 0, "index_select": 0}
        assert rel_err(got, 2.0 * prod + 0.5 * y) <= TOL
        ref = composed(opt, fn, torch.from_numpy(x), 2.0, 0.5,
                       torch.from_numpy(y)).numpy()
        assert rel_err(got, ref) <= TOL


def test_natural_view_refusals():
    _, opt, _, _ = operators("fem40_always")
    pack = opt.dev_tr
    with pytest.raises(TypeError):
        pack.natural_view(opt.perm_t.long())
    with pytest.raises(ValueError):
        pack.natural_view(opt.perm_t[:-1].contiguous())
    with pytest.raises(ValueError, match="relabeled order"):
        opt.nat_tr.natural_view(opt.perm_t)
    with pytest.raises(ValueError, match="natural view"):
        vt.tr_spmv_chain(opt.nat_tr, torch.zeros(opt.m), 2)
