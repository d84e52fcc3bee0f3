"""The two route guards of the port's operators.

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
