"""The port's chain TrSpMV (``ops/chain.py``) against the JAX chain kernel.

``y = (alpha * A.T)^n_iters @ x``.  The JAX package's ``tr_spmv_chain3``
runs its fused chain kernel (Pallas in interpret mode) on its own
``pack_stream3`` of a ``VBC1D``; the port's ``tr_spmv_chain`` runs on
``VBC1DDevice.from_host`` of the very same ``VBC1D``.  On the CPU the
port's wrapper runs its plain version, a loop of the plain TrSpMV; the
persistent CUDA kernel is held against that loop on the card in
``test_torch_cuda.py``.  Then ``VBCOperator.tr_mul_chain`` against the
JAX operator's, natural and auto-RCM, and the auto-RCM chain with its
``perm`` folded in (one launch) bitwise against the composed path it
replaces (gather x, the chain, gather y), also split across launches.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX kernel and the f64
oracle iterated on the host — f32 sums in other orders, as
``tests/test_pallas_v3.py`` holds the JAX chain to the f64 product.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv3 as pk3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky_matrix, fem_matrix  # noqa: E402
from chip_smoke import banded, long_stripes  # noqa: E402

TOL = 2e-5


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


def oracle(A, x, n_iters, alpha):
    a = 1.0 if alpha is None else alpha
    AT = A.T.astype(np.float64)
    y = x.astype(np.float64)
    for _ in range(n_iters):
        y = a * (AT @ y)
    return y


# the shapes of tests/test_pallas_v3.py: name -> (matrix, W, chunker)
CASES = {
    "natural_uniform8": lambda: (banded(1024, 1024, 6, 50, 1), 8,
                                 v.EquiChunker(8)),
    "multiclass_dp": lambda: (banded(500, 500, 5, 60, 12), 4,
                              v.DynamicTotalChunker(
                                  v.model_1dvbc_memory(4, 4), 4)),
    "long_multigroup_stripes": lambda: (long_stripes(), 8, v.EquiChunker(8)),
}


@pytest.mark.parametrize("alpha", [None, 0.5])
@pytest.mark.parametrize("n_iters", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax(case, n_iters, alpha):
    A, W, method = CASES[case]()
    B = v.vbc1d(A, W, method)
    if case == "multiclass_dp":
        assert len(set(B.Phi.widths().tolist())) > 1
    fmt3 = pk3.pack_stream3(B)
    assert fmt3 is not None
    x = np.random.default_rng(n_iters).standard_normal(A.shape[0]).astype(
        np.float32)
    yj = np.asarray(pk3.tr_spmv_chain3(fmt3, jnp.asarray(x), n_iters, alpha))
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    yt = vt.tr_spmv_chain(fmt, torch.from_numpy(x), n_iters, alpha).numpy()
    assert yt.dtype == np.float32 and yt.shape == (A.shape[1],)
    assert rel_err(yt, yj) <= TOL
    assert rel_err(yt, oracle(A, x, n_iters, alpha)) <= TOL
    # the plain loop is the wrapper's CPU path, exactly
    assert np.array_equal(
        yt, vt.tr_spmv_chain_plain(fmt, torch.from_numpy(x), n_iters,
                                   alpha).numpy())


@pytest.mark.parametrize("matrix", ["flagship_l2048", "fem80_auto_rcm"])
def test_operator_chain_matches_jax(matrix):
    if matrix == "fem80_auto_rcm":
        # relabeling starts at k = 80 (tests/test_torch_operator.py)
        A = fem_matrix(k=80).astype(np.float32)
    else:
        A = blocky_matrix(L=2048, w=8, d=8, band=300, seed=21)
    opj = v.VBCOperator.from_csc(A, W=8, use_pallas=True,
                                 directions="transposed")
    opt = vt.VBCOperator.from_csc(A, W=8, directions="transposed",
                                  device="cpu")
    assert (opt.row_perm is None) == (matrix == "flagship_l2048")
    if opj.row_perm is not None:
        np.testing.assert_array_equal(opt.row_perm, opj.row_perm)
    x = np.random.default_rng(5).standard_normal(A.shape[0]).astype(np.float32)
    yj = np.asarray(opj.tr_mul_chain(jnp.asarray(x), 3, 0.5))
    yt = opt.tr_mul_chain(torch.from_numpy(x), 3, 0.5).numpy()
    assert yt.dtype == np.float32 and yt.shape == (A.shape[1],)
    assert rel_err(yt, yj) <= TOL
    assert rel_err(yt, oracle(A, x, 3, 0.5)) <= TOL


def relabeled_fmt():
    """The FEM k=80 operator's relabeled pack (auto-RCM), its perm and its
    inverse, on the CPU."""
    A = fem_matrix(k=80).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device="cpu")
    assert op.row_perm is not None
    return A, op


def composed_chain(fmt, x, n_iters, alpha, perm, inv):
    """The path the mapped chain replaces: gather x into permuted space,
    the chain there, gather y out."""
    return vt.gather_plain(vt.tr_spmv_chain_plain(
        fmt, vt.gather_plain(x, perm), n_iters, alpha), inv)


@pytest.mark.parametrize("n_iters", [1, 2, 7])
def test_mapped_chain_is_the_composed_path(n_iters):
    """``perm`` folds the auto-RCM operator's two gathers into the chain:
    the plain version and the wrapper's CPU path are bitwise the composed
    path, and the operator's ``tr_mul_chain`` is that call."""
    A, op = relabeled_fmt()
    x = torch.from_numpy(np.random.default_rng(n_iters).standard_normal(
        A.shape[0]).astype(np.float32))
    want = composed_chain(op.dev_tr, x, n_iters, 0.25, op.perm_t,
                          torch.argsort(op.perm_t).int())
    assert torch.equal(vt.tr_spmv_chain_plain(op.dev_tr, x, n_iters, 0.25,
                                              op.perm_t), want)
    assert torch.equal(vt.tr_spmv_chain(op.dev_tr, x, n_iters, 0.25, op.perm_t), want)
    assert torch.equal(op.tr_mul_chain(x, n_iters, 0.25), want)
    assert rel_err(want.numpy(), oracle(A, x.numpy(), n_iters, 0.25)) <= TOL


def test_mapped_chain_split_into_launches(monkeypatch):
    """Across a split (a cap of 3 iterations a launch), the first launch
    gathers x through ``perm`` and the last stores through it: bitwise the
    composed path, the launches in between in permuted space."""
    from vbcs_tpu_torch.ops import chain

    monkeypatch.setattr(chain, "MAX_LAUNCH_ITERS", 3)
    A, op = relabeled_fmt()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(np.float32))
    runs = []
    plain = chain.tr_spmv_chain_plain
    monkeypatch.setattr(chain, "tr_spmv_chain_plain",
                        lambda f, xx, k, a=None: runs.append(k) or plain(f, xx, k, a))
    for n_iters, launches in ((7, [3, 3, 1]), (3, [3]), (1, [1])):
        runs.clear()
        got = chain.tr_spmv_chain(op.dev_tr, x, n_iters, 0.5, op.perm_t)
        assert runs == launches
        assert torch.equal(got, composed_chain(op.dev_tr, x, n_iters, 0.5,
                                               op.perm_t, torch.argsort(op.perm_t).int()))


def test_chain_refuses_a_bad_perm():
    _, op = relabeled_fmt()
    x = torch.zeros(op.m)
    with pytest.raises(TypeError):
        vt.tr_spmv_chain(op.dev_tr, x, 2, None, op.perm_t.long())
    with pytest.raises(ValueError):
        vt.tr_spmv_chain(op.dev_tr, x, 2, None, op.perm_t[:-1].contiguous())
    with pytest.raises(ValueError):
        vt.tr_spmv_chain_plain(op.dev_tr, x, 2, None, op.perm_t[:-1].contiguous())


def test_zero_iterations_return_x():
    A = banded(300, 300, 3, 30, 4)
    op = vt.VBCOperator.from_csc(A, W=8, device="cpu")
    x = torch.randn(300)
    y = op.tr_mul_chain(x, 0)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()  # a copy
    with pytest.raises(ValueError):
        op.tr_mul_chain(x, -1)
    fmt = vt.VBC1DDevice.from_host(op.host_tr, "cpu")
    with pytest.raises(ValueError):
        vt.tr_spmv_chain(fmt, x, 0)  # the kernel's wrapper needs >= 1


def test_nonsquare_raises():
    A = banded(300, 400, 5, 100, 10)
    op = vt.VBCOperator.from_csc(A, W=4, device="cpu")
    with pytest.raises(ValueError, match="square"):
        op.tr_mul_chain(torch.zeros(300), 2)
    with pytest.raises(ValueError, match="square"):
        vt.tr_spmv_chain(op.dev_tr, torch.zeros(300), 2)
    with pytest.raises(ValueError, match="square"):
        vt.tr_spmv_chain_plain(op.dev_tr, torch.zeros(300), 2)


def test_long_chain_splits_into_launches(monkeypatch):
    """A chain longer than MAX_LAUNCH_ITERS runs as several launches, each
    applying alpha; on the CPU each launch is the plain chain, so the
    split changes no bit of the result."""
    from vbcs_tpu_torch.ops import chain

    monkeypatch.setattr(chain, "MAX_LAUNCH_ITERS", 3)
    assert list(chain.launch_iters(10)) == [3, 3, 3, 1]
    assert list(chain.launch_iters(9)) == [3, 3, 3]
    assert list(chain.launch_iters(2)) == [2]
    A = banded(300, 300, 3, 30, 4)
    fmt = vt.VBC1DDevice.from_host(v.vbc1d(A, 8), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300).astype(
        np.float32))
    runs = []
    plain = chain.tr_spmv_chain_plain
    monkeypatch.setattr(chain, "tr_spmv_chain_plain",
                        lambda f, xx, k, a=None: runs.append(k) or plain(f, xx, k, a))
    got = chain.tr_spmv_chain(fmt, x, 10, 0.5)
    assert runs == [3, 3, 3, 1]
    assert torch.equal(got, plain(fmt, x, 10, 0.5))
    assert rel_err(got.numpy(), oracle(A, x.numpy(), 10, 0.5)) <= TOL


def test_launch_cap_is_the_launchers_int():
    from vbcs_tpu_torch.ops import chain

    assert chain.MAX_LAUNCH_ITERS == 2**31 - 1
    assert list(chain.launch_iters(2**31 + 4)) == [2**31 - 1, 5]
    assert list(chain.launch_iters(2**33)) == [2**31 - 1] * 4 + [4]
    assert all(0 < k <= 2**31 - 1 for k in chain.launch_iters(3 * 2**32 + 7))
    fmt = vt.VBC1DDevice.from_host(v.vbc1d(banded(50, 50, 3, 5, 2), 8), "cpu")
    x = torch.ones(50)
    with pytest.raises(TypeError):
        vt.tr_spmv_chain(fmt, x, 2.0)  # a count is an integer
    assert torch.equal(vt.tr_spmv_chain(fmt, x, np.int64(2)),
                       vt.tr_spmv_chain_plain(fmt, x, 2))
