"""The port's TrSpMV (``ops/trspmv.py``) against the JAX one-shot kernel.

Every case of ``tests/test_pallas_oneshot3.py`` runs through both: the
JAX package's ``tr_spmv_oneshot3`` on its ``mode="nat"`` pack (Pallas in
interpret mode) and the port's ``tr_spmv`` on ``VBC1DDevice.from_host``
of the very same JAX ``VBC1D``.  On the CPU the port's wrapper runs its
plain PyTorch version; the CUDA kernel is held against that plain
version on the card in ``test_torch_cuda.py``.

Tolerance: ``|Δ| / max|y| <= 2e-5`` — both sides sum in f32, in
different orders (the bound ``test_pallas_oneshot3.py`` uses against the
f64 product).  On basis vectors each output is one stored value times 1,
so the result must equal ``to_dense`` exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import dataclasses

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv3 as pk3
from vbcs_tpu_torch.ops.trspmv import (STAGE_COLS, STAGE_STRIPES, STAGE_WORDS,
                                       _cut_runs, stage_plan)
from spbench.gen import blocky, hpcg27

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


def banded(m, n, d, band, seed):
    r = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for j in range(n):
        c = int(j * m / n)
        rr = np.unique(np.clip(c + r.integers(-band, band, d), 0, m - 1))
        rows.extend(rr)
        cols.extend([j] * rr.size)
        vals.extend(r.standard_normal(rr.size))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()


def straddle_matrix():
    m = 2048
    rng = np.random.default_rng(7)
    dense = sp.coo_matrix(
        (rng.standard_normal(1600 * 8),
         (np.repeat(np.arange(1600), 8), np.tile(np.arange(8), 1600))),
        shape=(m, m),
    )
    diag = sp.coo_matrix(
        (np.ones(m - 8), (np.arange(8, m), np.arange(8, m))), shape=(m, m)
    )
    return (dense + diag).tocsc()


def grid_w5():
    k = 48
    n = k * k
    A = sp.diags(
        [np.full(n, 4.0), -np.ones(n - 1), -np.ones(n - 1),
         -np.ones(n - k), -np.ones(n - k)],
        [0, 1, -1, k, -k], format="csc").astype(np.float32)
    return A, v.SplitPartition(np.concatenate([np.arange(0, n, 5), [n]]))


# name -> (matrix, W, method, alpha, beta, pack kwargs)
CASES = {
    "natural_uniform8": lambda: (banded(1024, 1024, 6, 50, 1), 8,
                                 v.EquiChunker(8), None, None, {}),
    "alpha_fused": lambda: (banded(1024, 1024, 6, 50, 2), 8,
                            v.EquiChunker(8), 0.25, None, {}),
    "w4_slot_exit": lambda: (banded(800, 800, 5, 60, 3), 4,
                             v.EquiChunker(4), None, None, {}),
    "w1": lambda: (banded(300, 300, 3, 30, 4), 1, v.EquiChunker(1),
                   None, None, {}),
    "nonidentity_runs": lambda: (banded(512, 512, 40, 200, 6), 2,
                                 v.EquiChunker(2), None, None, {}),
    "straddle_carry": lambda: (straddle_matrix(), 8, v.EquiChunker(8),
                               None, None, {"ng": 128, "ns": 128}),
    "multiclass_dp": lambda: (banded(500, 500, 5, 60, 12), 4,
                              v.DynamicTotalChunker(
                                  v.model_1dvbc_memory(4, 4), 4),
                              None, None, {}),
    "rectangular": lambda: (banded(600, 900, 5, 60, 17), 8,
                            v.EquiChunker(8), None, None, {}),
    "beta_fused_natural": lambda: (banded(1024, 1024, 6, 50, 11), 8,
                                   v.EquiChunker(8), 0.5, 0.25, {}),
    "beta_posthoc": lambda: (banded(800, 800, 5, 60, 13), 4,
                             v.EquiChunker(4), None, 0.75, {}),
    "w5_multigroup": lambda: (*grid_w5()[:1], 8, grid_w5()[1], None, None,
                              {}),
}


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_tr_spmv_matches_jax_oneshot(case):
    A, W, method, alpha, beta, kw = CASES[case]()
    B = v.vbc1d(A, W, method)
    fmt3 = pk3.pack_stream3(B, mode="nat", **kw)
    assert fmt3 is not None
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    y0 = rng.standard_normal(A.shape[1]).astype(np.float32)
    yj = np.asarray(pk3.tr_spmv_oneshot3(
        fmt3, jnp.asarray(x), alpha, beta,
        None if beta is None else jnp.asarray(y0)))

    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    yt = vt.tr_spmv(fmt, torch.from_numpy(x), alpha, beta,
                    None if beta is None else torch.from_numpy(y0)).numpy()
    assert yt.dtype == np.float32 and yt.shape == (A.shape[1],)
    assert rel_err(yt, yj) <= TOL

    a = 1.0 if alpha is None else alpha
    want = a * (A.T @ x.astype(np.float64))
    if beta is not None:
        want = want + beta * y0.astype(np.float64)
    assert rel_err(yt, want) <= TOL


@pytest.mark.parametrize("method", ["equi8", "dp4"])
def test_basis_vectors_exact(method):
    A = banded(256, 256, 4, 20, seed=9)
    chunker = (vt.EquiChunker(8) if method == "equi8" else
               vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4))
    B = vt.vbc1d(A, 8, chunker)
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    D = B.to_dense().astype(np.float32)
    for i in list(range(0, 256, 37)) + [255]:
        e = torch.zeros(256)
        e[i] = 1.0
        np.testing.assert_array_equal(vt.tr_spmv(fmt, e).numpy(), D[i, :])


def test_from_host_checks():
    B = vt.vbc1d(banded(64, 64, 3, 8, seed=1), 8)
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    assert fmt.val.dtype == torch.float32 and fmt.idx.dtype == torch.int32
    assert fmt.col_stripe.numel() == 64
    bad = vt.VBC1D(m=B.m, n=B.n, W=B.W, Phi=B.Phi, pos=B.pos,
                   idx=B.idx + B.m, ofs=B.ofs, val=B.val)
    with pytest.raises(ValueError):
        vt.VBC1DDevice.from_host(bad, "cpu")
    big = vt.VBC1D(m=2**31, n=B.n, W=B.W, Phi=B.Phi, pos=B.pos, idx=B.idx,
                   ofs=B.ofs, val=B.val)
    with pytest.raises(ValueError):
        vt.VBC1DDevice.from_host(big, "cpu")
    with pytest.raises(TypeError):
        vt.tr_spmv(fmt, torch.zeros(64, dtype=torch.float64))
    with pytest.raises(ValueError):
        vt.tr_spmv(fmt, torch.zeros(63))


def test_empty_shapes():
    A = sp.csc_matrix((5, 0), dtype=np.float32)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, 8), "cpu")
    assert vt.tr_spmv(fmt, torch.ones(5)).shape == (0,)
    A = sp.csc_matrix((0, 4), dtype=np.float32)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, 8), "cpu")
    np.testing.assert_array_equal(vt.tr_spmv(fmt, torch.ones(0)).numpy(),
                                  np.zeros(4, np.float32))


# ---- the staged map's runs (ops/trspmv.stage_plan) ------------------------

def _stage_walk(fmt, plan, cols, stripes, words):
    """Each run's stripes, columns and stage words; raises where a split's
    (column, block, value) is not its stripe's, or a run breaks a bound it
    must keep or could have taken its next stripe."""
    spl, pos, ofs = (t.numpy().astype(np.int64) for t in (fmt.spl, fmt.pos, fmt.ofs))
    plan = plan.numpy().astype(np.int64)
    runs = plan[:, 0]
    assert runs[0] == 0 and runs[-1] == fmt.L and np.all(np.diff(runs) >= 1)
    assert np.array_equal(plan[:, 1:], np.stack([spl[runs], pos[runs], ofs[runs]], 1))
    used = ofs + pos

    def fits(s0, s1):
        return (spl[s1] - spl[s0] <= cols and s1 - s0 <= stripes
                and used[s1] - used[s0] <= words)

    for s0, s1 in zip(runs[:-1], runs[1:]):
        assert s1 - s0 == 1 or fits(s0, s1), f"run {s0}:{s1} breaks a bound"
        assert s1 == fmt.L or not fits(s0, s1 + 1), f"run {s0}:{s1} stops early"
    return runs


def _mixed_widths(seed=3, L=500, m=300):
    rng = np.random.default_rng(seed)
    splits = np.concatenate([[0], np.cumsum(rng.integers(1, 8, L))])
    D = sp.random(m, int(splits[-1]), 0.05, random_state=seed, format="csc",
                  dtype=np.float32)
    return vt.pack_1dvbc(vt.CSC.from_scipy(D), vt.SplitPartition(splits), 8)


def _wide_pack(splits, m=12):
    """A pack under the given stripe splits, every third row dense."""
    D = np.zeros((m, splits[-1]), np.float32)
    D[::3] = np.random.default_rng(5).standard_normal(((m + 2) // 3, splits[-1]))
    return vt.pack_1dvbc(vt.CSC.from_scipy(sp.csc_matrix(D)),
                         vt.SplitPartition(np.array(splits)), max(np.diff(splits)))


def _natural(A, direction):
    op = vt.VBCOperator.from_csc(A, W=8, directions=direction, reorder="always",
                                 device="cpu")
    which = "tr" if direction == "transposed" else "fw"
    return getattr(op, f"dev_{which}"), getattr(op, f"nat_{which}")


def _empty_stripes():
    A = banded(300, 128, 12, 60, 21).tolil()
    A[:, 16:48] = 0
    A[:, 88:96] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return vt.vbc1d(A, 3, vt.EquiChunker(3))


STAGE_PACKS = {  # name -> (pack, its natural view or None)
    "stencil27_11_natural_view": lambda: _natural(
        hpcg27.generate(None, nx=11, ny=11, nz=11), "forward"),
    "blocky_w8_l300_rcm": lambda: _natural(blocky.generate(0, L=300), "transposed"),
    "mixed_widths_1_7": lambda: (vt.VBC1DDevice.from_host(_mixed_widths(), "cpu"), None),
    "zero_block_stripes": lambda: (vt.VBC1DDevice.from_host(_empty_stripes(), "cpu"), None),
    "stripe_longer_than_a_stage": lambda: (vt.VBC1DDevice.from_host(
        vt.vbc1d(banded(9000, 12, 6000, 4500, 5), 3, vt.EquiChunker(3)), "cpu"), None),
    "one_stripe": lambda: (vt.VBC1DDevice.from_host(
        vt.vbc1d(banded(100, 5, 30, 50, 2), 5, vt.EquiChunker(5)), "cpu"), None),
    "stripe_wider_than_a_stage": lambda: (vt.VBC1DDevice.from_host(
        _wide_pack([0, 2, 8002, 8005]), "cpu"), None),
}


@pytest.mark.parametrize("bounds", [None, (8, 4, 64)])
@pytest.mark.parametrize("case", sorted(STAGE_PACKS))
def test_stage_plan_runs(case, bounds):
    """Every stripe in exactly one run, in order, each run within the
    column, stripe and stage bounds (or one stripe), none stopping before
    a bound (greedy); at the kernel's bounds (``stage_plan``, cached and
    shared with the natural view) and at tiny ones."""
    fmt, view = STAGE_PACKS[case]()
    if bounds is None:
        cols, stripes, words = STAGE_COLS, STAGE_STRIPES, STAGE_WORDS
        runs = stage_plan(fmt)
        assert stage_plan(fmt) is runs  # cached
        if view is not None:
            assert view.col_out is not None
            assert stage_plan(view) is runs  # shared
    else:
        cols, stripes, words = bounds
        runs = _cut_runs(fmt.spl.long(), fmt.pos.long(), fmt.ofs.long(), *bounds)
    assert runs.dtype == torch.int32 and runs.device == fmt.device
    assert runs.shape[1] == 4 and runs.is_contiguous()
    _stage_walk(fmt, runs, cols, stripes, words)


def test_stage_plan_long_stripe_is_a_run_of_its_own():
    fmt = STAGE_PACKS["stripe_longer_than_a_stage"]()[0]
    nblk = torch.diff(fmt.pos).numpy()
    long = np.flatnonzero(nblk * 4 > STAGE_WORDS)
    assert long.size
    runs = stage_plan(fmt).numpy()[:, 0]
    for s in long:
        assert s in runs and s + 1 in runs


@pytest.mark.parametrize("splits", [[0, 2, 8002, 8005], [0, 7200], [0, 1, 601, 603, 604]])
def test_stage_plan_wide_stripe_is_a_run_of_its_own(splits):
    """A stripe wider than a run's columns (or than a whole stage) is cut,
    not refused: a run of its own, its neighbours in runs of theirs."""
    fmt = vt.VBC1DDevice.from_host(_wide_pack(splits), "cpu")
    runs = stage_plan(fmt).numpy()[:, 0]
    wide = np.flatnonzero(np.diff(splits) > STAGE_COLS)
    assert wide.size
    for s in wide:
        assert s in runs and s + 1 in runs
    _stage_walk(fmt, stage_plan(fmt), STAGE_COLS, STAGE_STRIPES, STAGE_WORDS)


def test_stage_plan_follows_the_arrays():
    """A format whose splits are other arrays (a ``replace``) gets its own
    runs."""
    fmt = STAGE_PACKS["mixed_widths_1_7"]()[0]
    runs = stage_plan(fmt)
    cut = vt.VBC1DDevice.from_host(_mixed_widths(seed=4), "cpu")
    moved = dataclasses.replace(cut, stage_plans=fmt.stage_plans)
    assert not torch.equal(stage_plan(moved), runs)
    assert torch.equal(stage_plan(fmt), runs)  # cut anew, not moved's
