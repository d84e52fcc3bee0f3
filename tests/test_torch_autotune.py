"""The port's autotuner (``vbcs_tpu_torch/models/autotune.py``) against
the JAX package's (``vbcs_tpu/models/autotune.py``).

The synthetic families are bitwise the JAX package's; with the injected
time laws of ``tests/test_autotune.py`` both fits give the same tables
(``rtol=1e-9``: the same least squares on the same design) and the DP
plans under the two packages' models are equal.  The on-card measurement
is not run here: without ``measure=`` the port refuses a CPU device (its
card case is in ``test_torch_cuda.py``).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from test_autotune import ALPHA_COL, BETA_COL, measure_1d, measure_2d
from vbcs_tpu.models import autotune as aj
from vbcs_tpu_torch.models import autotune as at

KW1 = dict(W=3, d=4, target_bytes=1 << 18, band=64, cache=False)
KW2 = dict(U=2, W=3, d=4, target_bytes=1 << 18, band=64, rank=2, cache=False)


def same_csc(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("L, w, d, band, seed", [(1024, 8, 8, 400, 58),
                                                  (2048, 3, 4, 64, 23),
                                                  (1024, 1, 17, 400, 13)])
def test_synth_bitwise(L, w, d, band, seed):
    same_csc(at._synth(L, w, d, band, seed), aj._synth(L, w, d, band, seed))


@pytest.mark.parametrize("k", [64, 200])
def test_synth_fem_bitwise(k):
    same_csc(at._synth_fem(k), aj._synth_fem(k))


@pytest.mark.parametrize("K, u, L, w, d, band, seed", [
    (2048, 4, 1024, 8, 8, 400, 63), (3000, 1, 1024, 3, 4, 64, 40),
    (1536, 8, 1536, 8, 2, 400, 305)])
def test_synth2d_bitwise(K, u, L, w, d, band, seed):
    same_csc(at._synth2d(K, u, L, w, d, band, seed),
             aj._synth2d(K, u, L, w, d, band, seed))


def test_1d_fit_matches_jax():
    want = aj.autotune_1dvbc_trspmv(measure=measure_1d, **KW1)
    got = at.autotune_1dvbc_trspmv(measure=measure_1d, device="cpu", **KW1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1], BETA_COL, rtol=0.2)


@pytest.mark.parametrize("subsample", [True, False])
def test_2d_fit_matches_jax(subsample):
    want = aj.autotune_vbc_trspmv(measure=measure_2d, subsample=subsample, **KW2)
    got = at.autotune_vbc_trspmv(measure=measure_2d, subsample=subsample,
                                 device="cpu", **KW2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


def test_fit_1d_variants():
    """The fit of the cache's samples: the E block adds W columns, the
    constant one; an exact law of L and q leaves no residual, and its
    constant comes back."""
    rng = np.random.default_rng(0)
    ws = np.repeat([1, 2, 3], 4)
    Ls = rng.integers(1000, 5000, ws.size)
    qs = Ls * rng.integers(3, 9, ws.size)
    Gs = rng.integers(0, 50, ws.size)
    ts = 500.0 + ALPHA_COL[ws - 1] * Ls + BETA_COL[ws - 1] * qs
    data = dict(Ls=Ls.tolist(), ws=ws.tolist(), qs=qs.tolist(), Gs=Gs.tolist(),
                ts=ts.tolist())
    a, b, g, c, r = at.fit_1d(data, 3, with_E=False, with_const=True)
    np.testing.assert_allclose(a, ALPHA_COL, rtol=1e-6)
    np.testing.assert_allclose(b, BETA_COL, rtol=1e-6)
    assert not g.any() and c == pytest.approx(500.0, rel=1e-6) and r < 1e-9
    *_, r_no_const = at.fit_1d(data, 3, with_E=False)
    *_, r_e = at.fit_1d(data, 3, with_E=True)
    assert r_no_const > 1e-6 and r_e <= r_no_const + 1e-12


def test_dp_plans_match_jax_1d():
    tj = aj.autotune_1dvbc_trspmv(measure=measure_1d, **KW1)
    tt = at.autotune_1dvbc_trspmv(measure=measure_1d, device="cpu", **KW1)
    mj = v.ColumnBlockComponentCostModel(alpha_col=tj[0], beta_col=tj[1],
                                         gamma_col=tj[2])
    mt = vt.ColumnBlockComponentCostModel(alpha_col=tt[0], beta_col=tt[1])
    rng = np.random.default_rng(5)  # random rows: the DP mixes widths
    A = sp.coo_matrix((rng.standard_normal(2000), (rng.integers(0, 500, 2000),
                                                   rng.integers(0, 500, 2000))),
                      shape=(500, 500)).tocsc()
    pj = v.pack_stripe(v.CSC.from_scipy(A), v.DynamicTotalChunker(mj, 3))
    pt = vt.pack_stripe(vt.CSC.from_scipy(A), vt.DynamicTotalChunker(mt, 3))
    np.testing.assert_array_equal(pj.spl, pt.spl)
    assert len(np.unique(np.diff(pt.spl))) > 1  # the plan mixes widths


def test_dp_plans_match_jax_2d():
    tj = aj.autotune_vbc_trspmv(measure=measure_2d, **KW2)
    tt = at.autotune_vbc_trspmv(measure=measure_2d, device="cpu", **KW2)
    A = at._synth2d(300, 2, 200, 3, 3, 30, seed=7)

    def plan(pkg, t):
        mdl = pkg.BlockComponentCostModel(alpha_row=t[0], alpha_col=t[1],
                                          beta_row=t[2], beta_col=t[3])
        return pkg.pack_plaid(pkg.CSC.from_scipy(A), pkg.AlternatingPacker(
            pkg.EquiChunker(1), pkg.EquiChunker(1),
            pkg.DynamicTotalChunker(pkg.ConstrainedCost(mdl, pkg.VertexCount(), 3)),
            pkg.DynamicTotalChunker(pkg.ConstrainedCost(mdl.permuted(),
                                                        pkg.VertexCount(), 2)),
            pkg.DynamicTotalChunker(pkg.ConstrainedCost(mdl, pkg.VertexCount(), 3))))

    (Pj, Qj), (Pt, Qt) = plan(v, tj), plan(vt, tt)
    np.testing.assert_array_equal(Pj.spl, Pt.spl)
    np.testing.assert_array_equal(Qj.spl, Qt.spl)


def test_models_wrap_the_tables():
    m1 = at.model_1dvbc_trspmv_time(measure=measure_1d, device="cpu", **KW1)
    assert isinstance(m1, vt.ColumnBlockComponentCostModel)
    tt = at.autotune_1dvbc_trspmv(measure=measure_1d, device="cpu", **KW1)
    assert m1.stripe_cost(2, 10) == tt[0][1] + 10 * tt[1][1]
    m2 = at.model_vbc_trspmv_time(measure=measure_2d, device="cpu", **KW2)
    assert isinstance(m2, vt.BlockComponentCostModel) and m2.rank == 2


def test_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("VBCS_CACHE", str(tmp_path))
    kw1 = dict(KW1, cache=True)
    path = at.cache_path_1d(kw1["W"], kw1["d"], kw1["target_bytes"], kw1["band"],
                            device="cpu")
    assert path.startswith(str(tmp_path / "vbcs_tpu_torch" / "autotune"))
    with pytest.raises(FileNotFoundError):
        at.autotune_1dvbc_trspmv(require_cache=True, device="cpu", **kw1)
    fit = at.autotune_1dvbc_trspmv(measure=measure_1d, device="cpu", **kw1)
    with open(path) as fh:
        data = json.load(fh)
    assert len(data["data"]["ts"]) == 9 and set(data["data"]["kernels"]) == {"injected"}
    # the cache answers without measuring (a measure that fails if called)
    again = at.autotune_1dvbc_trspmv(measure=lambda B, w: 1 / 0, device="cpu", **kw1)
    for a, b in zip(fit, again):
        np.testing.assert_array_equal(a, b)
    kw2 = dict(KW2, cache=True)
    fit2 = at.autotune_vbc_trspmv(measure=measure_2d, device="cpu", **kw2)
    again2 = at.autotune_vbc_trspmv(measure=lambda *a: 1 / 0, device="cpu", **kw2)
    for a, b in zip(fit2[:2], again2[:2]):
        np.testing.assert_array_equal(a, b)
    # another device, another key; never the JAX package's directory
    assert at.cache_path_1d(device="cpu") != at.cache_path_1d(device="meta")
    assert "vbcs_tpu_torch" in at.cache_dir()


def test_measurement_refuses_a_cpu_device():
    B = vt.vbc1d(at._synth(1024, 2, 4, 64, seed=1), 8, vt.EquiChunker(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        at._measure_shipped(B, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        at.autotune_1dvbc_trspmv(cache=False, device="cpu", W=2, d=2,
                                 target_bytes=1 << 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        at.autotune_vbc_trspmv(cache=False, device="cpu", U=1, W=1, d=2,
                               target_bytes=1 << 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            at.autotune_1dvbc_trspmv(cache=False, device="cuda", W=2, d=2,
                                     target_bytes=1 << 16)
