"""The chain kernel's partition (``ops.chain.chain_plan``), on the CPU.

The persistent chain kernel (``csrc/chain.cu``) gives each block of its
cooperative launch a contiguous range of stripes, split into column
groups for its threads, stages the window of x rows that range reads,
and holds a prefix of the range (values and block rows, 4 bytes each,
each stripe's values aligned to its first column) in shared memory up
to a byte budget.  The partition is plain torch, so
it is checked here on the packs the chain runs: the flagship at ``L=2048``, the FEM at
``k=80`` relabeled by auto-RCM, one 1,600-block stripe beside width-8
diagonal stripes, and a multi-class DP plan.  The kernel itself is held
against its plain version at every residency in ``test_torch_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.ops.chain import ALIGN, COLUMN_WEIGHT, GROUP, chain_plan

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky_matrix, fem_matrix  # noqa: E402
from chip_smoke import banded, long_stripes  # noqa: E402

DEFAULT_BUDGET = 232_448  # an H100 block's shared-memory opt-in limit


def flagship():
    return vt.VBCOperator.from_csc(blocky_matrix(L=2048), W=8,
                                   directions="transposed", device="cpu").dev_tr


def fem_relabeled():
    op = vt.VBCOperator.from_csc(fem_matrix(k=80).astype(np.float32), W=8,
                                 reorder="auto", directions="transposed",
                                 device="cpu")
    assert op.row_perm is not None
    return op.dev_tr


def long_pack():
    return vt.VBC1DDevice.from_host(vt.vbc1d(long_stripes(), 8, vt.EquiChunker(8)),
                                    "cpu")


def multiclass():
    B = vt.vbc1d(banded(500, 500, 5, 60, 12), 4,
                 vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4))
    assert len(set(B.Phi.widths().tolist())) > 1
    return vt.VBC1DDevice.from_host(B, "cpu")


PACKS = {"flagship_l2048": flagship, "fem80_auto_rcm": fem_relabeled,
         "long_stripes": long_pack, "multiclass_dp": multiclass}


def stripe_costs(fmt):
    return (np.diff(fmt.ofs.numpy().astype(np.int64))
            + COLUMN_WEIGHT * np.diff(fmt.spl.numpy().astype(np.int64)))


@pytest.mark.parametrize("budget", [0, 4096, DEFAULT_BUDGET])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_partition(pack, budget):
    fmt = PACKS[pack]()
    L = fmt.L
    ofs = fmt.ofs.numpy().astype(np.int64)
    pos = fmt.pos.numpy().astype(np.int64)
    spl = fmt.spl.numpy().astype(np.int64)
    cost = stripe_costs(fmt)
    idx = fmt.idx.numpy().astype(np.int64)
    for blocks in (1, 7, 132):
        plan = chain_plan(fmt, blocks, budget)
        assert plan.buf.dtype == torch.int32
        assert torch.equal(plan.buf, torch.cat(plan[1:]))
        lo, res, win_lo, win, glo, pad, gcol = (
            t.numpy().astype(np.int64) for t in plan[1:])
        assert lo.shape == glo.shape == (blocks + 1,) and pad.shape == (L + 1,)
        # each resident stripe starts where its first column does, modulo
        # ALIGN, and ends before the next stripe's start
        assert pad[0] == 0 and np.all(pad % ALIGN == 0)
        assert np.all(np.diff(spl) + np.diff(pad) >= np.diff(ofs))
        # contiguous, ordered ranges that cover every stripe exactly once
        assert lo[0] == 0 and lo[-1] == L and np.all(np.diff(lo) >= 0)
        owner = np.repeat(np.arange(blocks), np.diff(lo))
        assert owner.size == L
        # column groups: up to GROUP adjacent columns of one stripe, each
        # column in exactly one, and block k's groups are those of its
        # stripes
        col_stripe = np.repeat(np.arange(L), np.diff(spl))
        stripe = col_stripe[gcol]
        assert np.all((gcol - spl[stripe]) % GROUP == 0)
        ends = np.minimum(gcol + GROUP, spl[stripe + 1])
        assert np.all(gcol[1:] == np.where(stripe[1:] == stripe[:-1], ends[:-1],
                                           spl[stripe[1:]]))
        assert gcol[0] == 0 and ends[-1] == fmt.n
        for k in range(blocks):
            g = gcol[glo[k]:glo[k + 1]]
            assert np.all((g >= spl[lo[k]]) & (g < spl[lo[k + 1]]))
        assert glo[-1] == gcol.size
        # a block stages its x window, every row its stripes read, where
        # the window fits beside its whole range (and only there)
        at = spl + pad + pos  # shared words before each stripe
        for k in range(blocks):
            rows = idx[pos[lo[k]]:pos[lo[k + 1]]]
            need = int(rows.max() - rows.min() + 1) if rows.size else 0
            fits = 4 * (at[lo[k + 1]] - at[lo[k]] + need) <= budget
            assert win[k] == (need if fits else 0)
            if win[k]:
                assert win_lo[k] == rows.min()
        # each resident prefix ends on a stripe boundary inside its range,
        # fits what the window leaves of the budget, and is the longest
        # that does
        assert np.all(lo[:-1] <= res) and np.all(res <= lo[1:])
        nbytes = 4 * (at[res] - at[lo[:-1]])
        assert np.all(nbytes + 4 * win <= budget)
        grow = res < lo[1:]
        more = 4 * (at[res + grow] - at[lo[:-1]])
        assert np.all(more[grow] + 4 * win[grow] > budget)
        if budget == 0:
            assert np.all(nbytes == 0) and np.all(win == 0)
        # no block carries more than the mean plus the largest stripe
        loads = np.add.reduceat(cost, lo[:-1][np.diff(lo) > 0])
        assert loads.max() <= cost.sum() / blocks + cost.max()


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_default_budget_holds_the_pack(pack):
    """At 132 blocks of the H100's largest budget, each of these packs is
    resident in full, and a banded pack's blocks stage their x windows."""
    fmt = PACKS[pack]()
    plan = chain_plan(fmt, 132, DEFAULT_BUDGET)
    assert torch.equal(plan.res, plan.lo[1:])
    if pack in ("flagship_l2048", "fem80_auto_rcm"):  # banded: every block
        assert bool((plan.win > 0).all())  # stages its x window


def walk(fmt, plan, x, alpha):
    """One iteration of the chain kernel as it reads the plan: each block
    copies its resident stripes into a shared buffer at the plan's
    offsets, then each column group sums its block rows, with x from the
    block's window where it has one."""
    spl, pos, idx, ofs, col_stripe = (t.numpy().astype(np.int64) for t in (
        fmt.spl, fmt.pos, fmt.idx, fmt.ofs, fmt.col_stripe))
    val = fmt.val.numpy()
    lo, res, win_lo, win, glo, pad, gcol = (t.numpy().astype(np.int64)
                                            for t in plan[1:])
    y = np.full(fmt.n, np.nan, np.float32)
    for k in range(lo.size - 1):
        c_lo, s_res = spl[lo[k]], res[k]
        at = spl - c_lo + pad - pad[lo[k]]  # a stripe's start in the copy
        sval = np.full(at[s_res], np.nan, np.float32)
        for s in range(lo[k], s_res):
            assert np.isnan(sval[at[s]:at[s] + ofs[s + 1] - ofs[s]]).all()
            sval[at[s]:at[s] + ofs[s + 1] - ofs[s]] = val[ofs[s]:ofs[s + 1]]
        for j in gcol[glo[k]:glo[k + 1]]:
            s = col_stripe[j]
            w = spl[s + 1] - spl[s]
            nc = min(GROUP, spl[s] + w - j)
            v, base = ((sval, at[s] + j - spl[s]) if s < s_res
                       else (val, ofs[s] + j - spl[s]))
            rows = idx[pos[s]:pos[s + 1]]
            if win[k]:
                assert rows.size == 0 or (rows.min() >= win_lo[k]
                                          and rows.max() < win_lo[k] + win[k])
            acc = np.zeros(nc, np.float32)
            for b, row in enumerate(rows):
                acc += v[base + b * w: base + b * w + nc] * x[row]
            assert np.isnan(y[j:j + nc]).all()
            y[j:j + nc] = alpha * acc
    return y


@pytest.mark.parametrize("blocks,budget", [(1, 0), (7, 400), (7, DEFAULT_BUDGET),
                                           (132, DEFAULT_BUDGET)])
@pytest.mark.parametrize("pack", ["long_stripes", "multiclass_dp"])
def test_plan_walk_computes_the_product(pack, blocks, budget):
    """The plan, read as the kernel reads it, covers every output column
    once, places no two resident values in one word and gives the plain
    TrSpMV."""
    fmt = PACKS[pack]()
    x = np.random.default_rng(blocks).standard_normal(fmt.m).astype(np.float32)
    got = walk(fmt, chain_plan(fmt, blocks, budget), x, 0.5)
    want = vt.tr_spmv_chain_plain(fmt, torch.from_numpy(x), 1, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def test_plan_is_cached_per_grid_and_budget():
    fmt = multiclass()
    a = chain_plan(fmt, 7, 4096)
    assert chain_plan(fmt, 7, 4096) is a
    assert chain_plan(fmt, 7, 0) is not a
    assert set(fmt.chain_plans) == {(7, 4096), (7, 0)}
    with pytest.raises(ValueError):
        chain_plan(fmt, 0, 4096)
    with pytest.raises(ValueError):
        chain_plan(fmt, 7, -1)
