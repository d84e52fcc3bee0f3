"""The port's scatter tier (``ops/scatter.py``) against the JAX one.

The JAX package's ``pallas_scatter.tr_spmv_scatter`` (Pallas in
interpret mode, with its multipass entry gather and exit permute) and
the port's ``tr_spmv_scatter`` run on packs of the very same JAX
``VBC1D``: the cases of ``tests/test_scatter.py``.  On the CPU the port's
wrapper runs its plain version (``index_add_`` over the CSC); the
column-parallel CUDA kernel is held against it on the card in
``test_torch_cuda.py``.  Then the guard and the operator's route.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX kernel and the f64
product — f32 sums in other orders, the bound ``test_scatter.py`` uses.
``column_entries`` is a host function and must be bitwise equal.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.operator import route_tr_spmv as route_jax
from vbcs_tpu.ops import pallas_scatter as ps
from vbcs_tpu_torch.ops import scatter as pst

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import fem_matrix  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def scattered(m, n, nnz, seed):
    rng = np.random.default_rng(seed)
    A = sp.coo_matrix((rng.standard_normal(nnz).astype(np.float32),
                       (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return A


def heavy(col_entries):
    A = scattered(2000, 2000, 12000, seed=3).tolil()
    A[:col_entries, 5] = 1.5
    return A.tocsc()


def blocky():
    d = sp.random(64, 64, 0.3, random_state=5)
    return sp.kron(d, np.ones((8, 8))).tocsc().astype(np.float32)


def pack(A, W=8, method=None):
    method = method or v.DynamicTotalChunker(v.model_1dvbc_memory(4, 8), W)
    return v.vbc1d(v.CSC.from_scipy(A), W, method)


# the cases of tests/test_scatter.py: name -> matrix
CASES = {
    "square_5000": lambda: scattered(5000, 5000, 35000, seed=1),
    "rect_3000x6000": lambda: scattered(3000, 6000, 20000, seed=2),
    "column_of_40": lambda: heavy(40),
    "column_of_90": lambda: heavy(90),  # past the JAX kernel's 64-entry spill
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_column_entries_bitwise(case):
    B = pack(CASES[case]())
    for want, got in zip(ps._column_entries(B), pst.column_entries(B)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_matches_jax(case):
    A = CASES[case]()
    B = pack(A)
    fmt_j = ps.pack_scatter(B)
    fmt_t = pst.pack_scatter(B, "cpu")
    assert fmt_j is not None and fmt_t is not None
    if case == "column_of_90":
        assert fmt_j.n_spill > 0  # the JAX side took its COO spill
    assert (fmt_t.m, fmt_t.n) == A.shape
    x = np.random.default_rng(7).standard_normal(A.shape[0]).astype(np.float32)
    yj = np.asarray(ps.tr_spmv_scatter(fmt_j, jnp.asarray(x)))
    yt = vt.tr_spmv_scatter(fmt_t, torch.from_numpy(x)).numpy()
    want = A.T.astype(np.float64) @ x.astype(np.float64)
    assert yt.dtype == np.float32 and yt.shape == (A.shape[1],)
    assert rel_err(yt, yj) <= TOL
    assert rel_err(yt, want) <= TOL
    # alpha/beta/y fused as in the stripe wrapper
    y0 = np.random.default_rng(8).standard_normal(A.shape[1]).astype(np.float32)
    yt = vt.tr_spmv_scatter(fmt_t, torch.from_numpy(x), -1.5, 0.5,
                            torch.from_numpy(y0)).numpy()
    assert rel_err(yt, -1.5 * want + 0.5 * y0) <= TOL


@pytest.mark.parametrize("case", sorted(CASES) + ["blocky"])
def test_guard_matches_jax(case):
    A = blocky() if case == "blocky" else CASES[case]()
    method = v.EquiChunker(8) if case == "blocky" else None
    B = pack(A, method=method)
    assert (ps.pack_scatter(B) is None) == (pst.pack_scatter(B, "cpu") is None)
    assert pst.scatter_admits(B) == (case != "blocky")


def test_scatter_format_layout():
    """The CSC keeps explicit fill, in block order within each column,
    and an empty column has an empty range."""
    D = np.zeros((6, 4), np.float32)
    D[[0, 2, 5], 0] = [1, 2, 3]
    D[1, 1] = 4
    D[[1, 4], 3] = [5, 6]  # column 2 is empty, a stripe of its own
    B = vt.vbc1d(sp.csc_matrix(D), 2,
                 vt.SplitPartition(np.array([0, 2, 3, 4])))
    fmt = vt.ScatterDevice.from_host(B, "cpu")
    assert fmt.colptr.dtype == fmt.row.dtype == torch.int32
    assert fmt.colptr[2] == fmt.colptr[3]
    assert fmt.row.numel() == B.val.size  # fill kept
    assert fmt.nbytes == 4 * (fmt.n + 1 + 2 * fmt.row.numel())
    rows = fmt.row.numpy()
    for j in range(4):
        seg = rows[int(fmt.colptr[j]):int(fmt.colptr[j + 1])]
        assert np.all(np.diff(seg) > 0)
    x = torch.arange(1, 7, dtype=torch.float32)
    np.testing.assert_array_equal(vt.tr_spmv_scatter(fmt, x).numpy(),
                                  D.T @ np.arange(1, 7, dtype=np.float32))


def test_from_host_refuses_inconsistent_pack():
    B = vt.vbc1d(scattered(50, 40, 100, seed=4), 8)
    B.ofs[-1] += 1
    with pytest.raises(ValueError, match="inconsistent"):
        vt.ScatterDevice.from_host(B, "cpu")


def test_operator_routes_scatter_as_jax():
    # one stripe 16 columns wide, the rest 1: the JAX one-shot refuses
    # widths past 8, and the mean width (~1.004) admits the scatter tier
    A = scattered(3000, 3000, 20000, seed=2)
    B = pack(A, 16, v.SplitPartition(np.r_[0, np.arange(16, 3001)]))
    name_j, fmt_j, call_j = route_jax(B)
    assert name_j == "scatter"
    name, fmt, call = vt.route_tr_spmv(B, "cpu")
    assert name == "scatter" and call is vt.tr_spmv_scatter
    x = np.random.default_rng(8).standard_normal(3000).astype(np.float32)
    yj = np.asarray(call_j(fmt_j, jnp.asarray(x)))
    assert rel_err(call(fmt, torch.from_numpy(x)).numpy(), yj) <= TOL
    op = vt.VBCOperator.from_host(B, None, None, "cpu")
    assert op.route_tr[0] == "scatter"
    assert rel_err(op.tr_mul(torch.from_numpy(x)).numpy(), yj) <= TOL


def test_route_keeps_blocked_packs_on_the_stripe_kernel():
    """Widths 8 and 3 stay on the stripe kernel; the relabeled FEM's
    stripes of ~1.98 are within the guard's 2.0 and take the scatter
    kernel (the faster of the two on an H100 at 1.99, PERF.md)."""
    for w in (8, 3):
        B = pack(blocky(), method=v.EquiChunker(w))
        name, fmt, call = vt.route_tr_spmv(B, "cpu")
        assert name == "stripe" and call is vt.tr_spmv
        assert isinstance(fmt, vt.VBC1DDevice)
    op = vt.VBCOperator.from_csc(fem_matrix(k=80).astype(np.float32), W=8,
                                 device="cpu")
    assert op.row_perm is not None
    assert 1.5 < np.diff(op.host_tr.Phi.spl).mean() < pst.MAX_MEAN_WIDTH
    assert op.route_tr[0] == op.route_fw[0] == "scatter"


@pytest.mark.parametrize("reorder", ["never", "auto"])
def test_operator_alpha_beta_y(reorder):
    """Both directions through the scatter route with alpha, beta and y,
    on a natural operator and on one that auto-RCM relabels, against the
    f64 product."""
    A = scattered(8000, 8000, 56000, seed=9)
    op = vt.VBCOperator.from_csc(A, W=8, reorder=reorder, device="cpu")
    assert (op.row_perm is not None) == (reorder == "auto")
    assert op.route_tr[0] == op.route_fw[0] == "scatter"
    m, n = A.shape
    rng = np.random.default_rng(9)
    x_tr, y_tr = (rng.standard_normal(k).astype(np.float32) for k in (m, n))
    x_fw, y_fw = (rng.standard_normal(k).astype(np.float32) for k in (n, m))
    A64 = A.astype(np.float64)
    for fn, x, y, want in (
            ("tr_mul", x_tr, y_tr, 0.5 * (A64.T @ x_tr) + 0.25 * y_tr),
            ("mul", x_fw, y_fw, -2.0 * (A64 @ x_fw) + 1.5 * y_fw)):
        alpha, beta = (0.5, 0.25) if fn == "tr_mul" else (-2.0, 1.5)
        got = getattr(op, fn)(torch.from_numpy(x), alpha, beta,
                              torch.from_numpy(y)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert rel_err(got, want) <= TOL, fn
        bare = getattr(op, fn)(torch.from_numpy(x)).numpy()
        assert rel_err(bare, A64.T @ x if fn == "tr_mul" else A64 @ x) <= TOL
