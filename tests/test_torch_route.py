"""The route table and the two route guards of the port's operators.

* The route table, ``operator._KERNEL_DTYPES``: which calls of which
  operator run a kernel for which matrix dtype (an x of the matrix's
  dtype), every other call the semiring route; pinned here call kind by
  call kind, so that a new kernel dtype edits the table and this test.

* The 1-D scatter guard, ``ops.scatter.scatter_admits``: the scatter
  kernel for packs of mean stripe width below ``MAX_MEAN_WIDTH`` (2.0,
  the JAX package's ``pallas_scatter`` threshold, which admits 2.0 itself;
  on an H100 the stripe kernel is the faster there), the stripe kernel
  from it up.
* The 2-D guard, ``operator.tile2d_worthwhile``: the tile kernel when the
  stored-value-weighted mean tile height is at least
  ``TILE2D_MIN_HEIGHT``, else the stripe kernel on the pack's 1-D view.
  ``route_tr_spmv_2d``, ``VBC2DOperator.tr_mul``/``mul`` and the
  autotuner's ``_measure_shipped_2d`` all ask it.

On the CPU every route runs its kernel's plain version, so both routes
must give the same y (``|Δ| <= 2e-5 max|y|``, f32 sums in another order)
and agree with the f64 product.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_scatter as ps
from vbcs_tpu_torch import operator as op_mod
from vbcs_tpu_torch.models import autotune as at
from vbcs_tpu_torch.ops import scatter as pst
from vbcs_tpu_torch.utils import trace

TOL = 2e-5


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(n * d).astype(np.float32),
                       (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def widths_plan(widths):
    return np.concatenate([[0], np.cumsum(widths)])


# mean stripe widths about the threshold: 1.5, exactly 2.0, just above, 3
PLANS = {
    "mean_1.5": [1, 2] * 60,
    "mean_2.0": [1, 3] * 60,
    "mean_2.0083": [1, 3] * 59 + [2, 3],
    "mean_3.0": [3] * 120,
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_scatter_guard_at_the_threshold(plan):
    assert pst.MAX_MEAN_WIDTH == ps.MAX_MEAN_WIDTH == 2.0
    widths = PLANS[plan]
    n = sum(widths)
    A = banded(300, n, 4, 30, 3)
    Bj = v.vbc1d(v.CSC.from_scipy(A), 8, v.SplitPartition(widths_plan(widths)))
    mean = float(np.mean(widths))
    admits = pst.scatter_admits(Bj)
    assert admits == (mean < 2.0)
    assert (ps.pack_scatter(Bj) is not None) == (mean <= 2.0)  # JAX's
    name, fmt, call = vt.route_tr_spmv(Bj, "cpu")
    assert name == ("scatter" if admits else "stripe")
    x = np.random.default_rng(4).standard_normal(300).astype(np.float32)
    assert rel_err(call(fmt, torch.from_numpy(x)).numpy(),
                   A.T.astype(np.float64) @ x) <= TOL


def pack2d(A, heights, W=8):
    """A 2-D pack of ``A`` with row blocks of the given heights and
    stripes of width ``W``."""
    C = vt.CSC.from_scipy(A)
    return vt.pack_vbc2d(C, vt.SplitPartition(widths_plan(heights)),
                         vt.SplitPartition.equi(C.n, W), max(heights), W)


def test_mean_tile_height():
    """``sum(u^2 w) / sum(u w)`` over the tiles: the height of the tile
    that holds a stored value, on average over the stored values."""
    D = np.zeros((6, 4), np.float32)
    D[0, 0:2] = 1  # a height-1 tile in stripe 0
    D[1:5, 2:4] = 2  # a height-4 tile in stripe 1
    B2 = pack2d(sp.csc_matrix(D), [1, 4, 1], W=2)
    assert B2.num_blocks == 2
    assert vt.mean_tile_height(B2) == pytest.approx((1 * 2 + 16 * 2) / (2 + 8))
    empty = pack2d(sp.csc_matrix((6, 4), dtype=np.float32), [2, 2, 2], W=2)
    assert vt.mean_tile_height(empty) == 0.0


# weighted mean heights 1, 4, (1 + 9) / 4 = 2.5, (3 + 4) / 5 = 1.4, 2
@pytest.mark.parametrize("heights, want", [([1] * 400, "view"),
                                           ([4] * 100, "tile2d"),
                                           ([1, 3] * 100, "tile2d"),
                                           ([1, 1, 1, 2] * 80, "view"),
                                           ([2] * 200, "tile2d")])
def test_2d_guard_picks_and_both_routes_agree(heights, want):
    A = banded(400, 320, 6, 40, 5)
    B2 = pack2d(A, heights)
    assert op_mod.TILE2D_MIN_HEIGHT == 2.0
    assert vt.tile2d_worthwhile(B2) == (want == "tile2d")
    name, fmt, call = vt.route_tr_spmv_2d(B2, "cpu")
    assert name == want
    x = np.random.default_rng(6).standard_normal(400).astype(np.float32)
    y = np.random.default_rng(7).standard_normal(320).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dev2 = vt.VBC2DDevice.from_host(B2, "cpu")
    tile = vt.tr_spmv_2d(dev2, xt, 0.5, 0.25, yt).numpy()
    view = vt.tr_spmv(dev2.view_1d(), xt, 0.5, 0.25, yt).numpy()
    routed = call(fmt, xt, 0.5, 0.25, yt).numpy()
    want_y = 0.5 * (A.T.astype(np.float64) @ x) + 0.25 * y
    for got in (tile, view, routed):
        assert rel_err(got, want_y) <= TOL
    assert rel_err(tile, view) <= TOL


def test_operator_2d_takes_the_guarded_route():
    """A height-1 default plan (the flagship-like blocky matrix at U=W=8)
    routes ``tr_mul`` to the view; the A.T pack's full-height tiles route
    ``mul`` to the tile kernel; both agree with the f64 products."""
    from bench import blocky_matrix

    A = blocky_matrix(L=256)
    op = vt.VBC2DOperator.from_csc(A, 8, 8, device="cpu")
    for host, route in ((op.host_tr, op.route_tr), (op.host_fw, op.route_fw)):
        assert route[0] == ("tile2d" if vt.tile2d_worthwhile(host) else "view")
    assert op.route_tr[0] == "view" and op.route_fw[0] == "tile2d"
    assert op.route_tr[1] is op.view_tr  # the view route shares the SpMM's view
    rng = np.random.default_rng(8)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    A64 = A.astype(np.float64)
    assert rel_err(op.tr_mul(torch.from_numpy(x), 2.0).numpy(),
                   2.0 * (A64.T @ x)) <= TOL
    assert rel_err(op.mul(torch.from_numpy(x)).numpy(), A64 @ x) <= TOL


def test_autotuner_times_the_guarded_route(monkeypatch):
    """``_measure_shipped_2d`` routes through ``route_tr_spmv_2d``, so it
    times the kernel the guard picks: moving the threshold moves it."""
    asked = []
    guard = op_mod.tile2d_worthwhile

    def spy(B2):
        asked.append(B2)
        return guard(B2)

    monkeypatch.setattr(op_mod, "tile2d_worthwhile", spy)
    monkeypatch.setattr(at, "_card", lambda device: torch.device(device))
    monkeypatch.setattr(at, "_chain_s", lambda call, fmt, device, nbytes: 1e-6)
    B2 = pack2d(banded(400, 320, 6, 40, 9), [4] * 100)
    assert at._measure_shipped_2d(B2, "cpu") == (1e-6, "tile2d")
    assert asked == [B2]
    monkeypatch.setattr(op_mod, "TILE2D_MIN_HEIGHT", 5.0)
    assert at._measure_shipped_2d(B2, "cpu") == (1e-6, "view")
    B = vt.vbc1d(banded(300, 300, 4, 30, 2), 8, vt.EquiChunker(1))
    assert at._measure_shipped(B, "cpu") == (1e-6, "scatter")


# The kernels' dtypes by operator and call kind: a call runs its kernel
# when x has the matrix's dtype and that dtype is listed here
KERNEL_DTYPES = {
    ("1d", "vec"): {"float32", "float64"},
    ("1d", "mat"): {"float32"},
    ("1d", "chain"): {"float32"},
    ("2d", "vec"): {"float32"},
    ("2d", "mat"): {"float32"},
}
# each call: its operator, kind, direction and how it is made
CALLS = {
    "1d.tr_mul": ("1d", "vec", lambda op, x, X: op.tr_mul(x, 2.0, 0.5, x)),
    "1d.mul": ("1d", "vec", lambda op, x, X: op.mul(x)),
    "1d.tr_mul_mat": ("1d", "mat", lambda op, x, X: op.tr_mul_mat(X)),
    "1d.mul_mat": ("1d", "mat", lambda op, x, X: op.mul_mat(X)),
    "1d.tr_mul_chain": ("1d", "chain", lambda op, x, X: op.tr_mul_chain(x, 2)),
    "2d.tr_mul": ("2d", "vec", lambda op, x, X: op.tr_mul(x, 2.0, 0.5, x)),
    "2d.mul": ("2d", "vec", lambda op, x, X: op.mul(x)),
    "2d.tr_mul_mat": ("2d", "mat", lambda op, x, X: op.tr_mul_mat(X)),
    "2d.mul_mat": ("2d", "mat", lambda op, x, X: op.mul_mat(X)),
}


def test_the_route_table_is_pinned():
    assert {k: {str(d).removeprefix("torch.") for d in v}
            for k, v in op_mod._KERNEL_DTYPES.items()} == KERNEL_DTYPES


def spy_kernels(monkeypatch):
    """Records the kernel each operator call runs: the route's name for
    ``tr_mul``/``mul``, ``"spmm"`` and ``"chain"`` for the others."""
    ran = []

    def routed(real):
        def route(*a, **k):
            name, fmt, call = real(*a, **k)
            return name, fmt, lambda *b, **kw: ran.append(name) or call(*b, **kw)
        return route

    for name in ("route_tr_spmv", "route_tr_spmv_2d"):
        monkeypatch.setattr(op_mod, name, routed(getattr(op_mod, name)))
    for name, kernel in (("tr_spmm", "spmm"), ("tr_spmv_chain", "chain")):
        real = getattr(op_mod, name)
        monkeypatch.setattr(op_mod, name, lambda *a, real=real, kernel=kernel:
                            ran.append(kernel) or real(*a))
    return ran


@pytest.mark.parametrize("xdtype", ["float32", "float64"])
@pytest.mark.parametrize("mdtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_call_takes_the_route_the_table_names(call, mdtype, xdtype, monkeypatch):
    """Every call kind of both operators, for an f32, f64 and int32 matrix
    and an f32 and f64 x: the kernel (by name) where the table lists the
    matrix's dtype and x has it, else one semiring call in x's dtype
    (``trace.semiring_calls``) and no kernel."""
    shape, kind, run = CALLS[call]
    A = sp.csc_matrix(banded(200, 200, 4, 20, 11).toarray().round()).astype(mdtype)
    ran = spy_kernels(monkeypatch)
    op = (vt.VBCOperator.from_csc(A, W=8, device="cpu") if shape == "1d"
          else vt.VBC2DOperator.from_csc(A, 4, 8, device="cpu"))
    g = torch.Generator().manual_seed(2)
    dt = getattr(torch, xdtype)
    x, X = torch.randn(200, generator=g).to(dt), torch.randn(200, 3, generator=g).to(dt)
    before = trace.semiring_calls()
    out = run(op, x, X)
    after = trace.semiring_calls()
    moved = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert out.dtype == dt
    if mdtype == xdtype and mdtype in KERNEL_DTYPES[shape, kind]:
        if kind == "vec":
            host = op.host_tr if call.endswith("tr_mul") else op.host_fw
            if shape == "2d":
                want = "tile2d" if vt.tile2d_worthwhile(host) else "view"
            else:  # the scatter kernel is f32's alone
                want = ("scatter" if mdtype == "float32" and pst.scatter_admits(host)
                        else "stripe")
        else:
            want = {"mat": "spmm", "chain": "chain"}[kind]
        assert (ran, moved) == ([want], {})
    else:
        assert (ran, moved) == ([], {xdtype: 1})


@pytest.mark.parametrize("dtype, asked, route", [(np.float32, 1, "scatter"),
                                                 (np.float64, 0, "stripe")])
def test_a_route_build_asks_the_scatter_guard_once(dtype, asked, route, monkeypatch):
    """``route_tr_spmv`` alone asks the scatter guard, once a route build
    of an f32 pack (this band's narrow stripes: the scatter kernel) and
    never for an f64 one (the stripe kernel's alone)."""
    calls = []
    guard = pst.scatter_admits
    monkeypatch.setattr(pst, "scatter_admits", lambda B: calls.append(B) or guard(B))
    op = vt.VBCOperator.from_csc(banded(300, 300, 4, 30, 2).astype(dtype), W=8,
                                 device="cpu")
    x = torch.ones(300, dtype=getattr(torch, np.dtype(dtype).name))
    op.tr_mul(x)
    op.mul(x)
    op.tr_mul(x)
    assert op.route_tr[0] == op.route_fw[0] == route
    assert len(calls) == 2 * asked
