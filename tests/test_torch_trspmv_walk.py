"""The stripe kernel's thread maps and sum order (``csrc/trspmv.cu``), in
NumPy, and the format flag that picks its map.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``).  Here
the CPU checks what its launch and maps promise:

* ``VBC1DDevice.quad_widths`` (every stripe width a multiple of 4, the
  float4 map) is right on every kind of pack, and the natural views, the
  distributed paths' formats and the 2-D pack's 1-D view carry it;
* the float4 map, as the launcher cuts it (a block the stripes of about
  1,024 columns, a thread four columns 1,024 apart in turn, its stripe by
  a binary search of the block's splits), gives every column to exactly
  one thread, four columns of one stripe at a time;
* the staged map, walked as the kernel walks it (a block a run of
  ``ops.trspmv.stage_plan``, the run's values copied into a stage in
  16-byte words from a window rounded out on the values' alignment, x
  gathered once a block row; a stripe whose values do not fit a stage in
  passes of a block's columns and, in each, chunks of block rows, the
  pass's values copied a word at a time), reads only staged words and
  gives each column the bits of its sum in block order;
* a column's f32 sum (its blocks in block order with ``fmaf``, then alpha
  and beta) agrees with the plain version, and its bits are the same on a
  format cut at stripe boundaries or with its stripes reordered.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.ops.trspmv import (STAGE_COLS, STAGE_STRIPES, STAGE_WORDS,
                                       _cut_runs)
from vbcs_tpu_torch.parallel.shard import permute_stripes, shard_1d, split_ranges
from vbcs_tpu_torch.tools.matrices import blocky_matrix

F32 = np.float32
TOL = 2e-5
THREADS, QUAD_COLS, MAX_GROUP = 256, 1024, 2048  # the kernel's constants


def fmaf(a, b, c):
    a, b, c = (np.asarray(v, dtype=np.float64) for v in (a, b, c))
    return (a * b + c).astype(F32)


def column_sums(B, x, alpha, beta, y_in):
    """y as both maps compute it: each column's blocks in block order."""
    spl, pos, ofs = (np.asarray(a, dtype=np.int64) for a in (B.Phi.spl, B.pos, B.ofs))
    idx, val = np.asarray(B.idx, dtype=np.int64), np.asarray(B.val, dtype=F32)
    w = np.diff(spl)
    s = np.repeat(np.arange(w.size), w)  # col_stripe
    j = np.arange(B.n)
    acc = np.zeros(B.n, F32)
    for k in range(int(np.diff(pos).max(initial=0))):  # the k-th block of each column
        on = pos[s] + k < pos[s + 1]
        b = pos[s[on]] + k
        v = val[ofs[s[on]] + k * w[s[on]] + j[on] - spl[s[on]]]
        acc[on] = fmaf(v, np.asarray(x, F32)[idx[b]], acc[on])
    return fmaf(F32(beta), np.asarray(y_in, F32), (F32(alpha) * acc).astype(F32))


def quad_map(B):
    """For each column, the (block, thread, first column of its quad) the
    float4 map gives it; raises where a quad would leave its stripe."""
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    L, n = spl.size - 1, int(spl[-1])
    G = min(MAX_GROUP, max(1, L * QUAD_COLS // n))
    owner = np.full((n, 3), -1, np.int64)
    for blk in range(-(-L // G)):
        s0 = blk * G
        m_spl = spl[s0:min(L, s0 + G) + 1]
        for t in range(THREADS):
            for j in range(int(m_spl[0]) + 4 * t, int(m_spl[-1]), 4 * THREADS):
                g = np.searchsorted(m_spl, j, side="right") - 1  # the binary search
                if j + 4 > m_spl[g + 1]:
                    raise AssertionError(f"quad at {j} leaves stripe {s0 + g}")
                assert (owner[j:j + 4] == -1).all(), f"column {j} taken twice"
                owner[j:j + 4] = (blk, t, j)
    return owner


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    vals = rng.standard_normal(n * d).astype(F32)
    A = sp.coo_matrix((vals, (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def split_pack(splits, m=40, seed=6):
    """A pack of an m x splits[-1] matrix under the given stripe splits,
    every third row filled."""
    n = splits[-1]
    D = np.zeros((m, n), F32)
    D[::3] = np.random.default_rng(seed).standard_normal(((m + 2) // 3, n))
    return vt.pack_1dvbc(vt.CSC.from_scipy(sp.csc_matrix(D)),
                         vt.SplitPartition(np.array(splits)), max(np.diff(splits)))


def empty_stripes_pack():
    A = banded(300, 128, 12, 60, 21).tolil()
    A[:, 16:48] = 0
    A[:, 88:96] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return vt.vbc1d(A, 8, vt.EquiChunker(8))


PACKS = {  # name -> (host pack, every width a multiple of 4)
    **{f"width_{w}": (lambda w=w: vt.vbc1d(banded(120, 4 * w, 40, 60, w), w,
                                          vt.EquiChunker(w)), w % 4 == 0)
       for w in (1, 2, 3, 4, 5, 6, 7, 8, 16, 40)},
    "empty_stripes": (empty_stripes_pack, True),
    "zero_width_stripe_in_quads": (lambda: split_pack([0, 8, 8, 12, 20]), True),
    "zero_width_stripe_odd": (lambda: split_pack([0, 3, 3, 8, 13]), False),
    "flagship_l1000": (lambda: vt.vbc1d(blocky_matrix(L=1000), 8),
                       True),
    "multiclass_dp": (lambda: vt.vbc1d(
        banded(200, 200, 5, 40, 12), 4,
        vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4)), False),
    "tall_rectangle": (lambda: vt.vbc1d(banded(300, 96, 5, 40, 22), 8,
                                        vt.EquiChunker(8)), True),
    "wide_rectangle": (lambda: vt.vbc1d(banded(60, 240, 4, 20, 23), 8), None),
}


@pytest.mark.parametrize("case", sorted(PACKS))
def test_quad_widths_flag(case):
    make, want = PACKS[case]
    B = make()
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    if want is None:  # as the planner cut it
        want = bool(np.all(np.diff(np.asarray(B.Phi.spl)) % 4 == 0))
    assert fmt.quad_widths is want
    if fmt.m == fmt.n:
        perm = torch.from_numpy(np.random.default_rng(1).permutation(fmt.n)
                                .astype(np.int32))
        assert fmt.natural_view(perm).quad_widths is want


@pytest.mark.parametrize("case", [c for c, (_, q) in sorted(PACKS.items()) if q])
def test_quad_map_gives_each_column_to_one_thread(case):
    B = PACKS[case][0]()
    owner = quad_map(B)
    assert (owner[:, 0] >= 0).all()
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    stripe = np.repeat(np.arange(spl.size - 1), np.diff(spl))
    first = owner[:, 2]
    assert np.array_equal(stripe, stripe[first])  # a quad stays in its stripe
    assert np.array_equal(first, np.arange(B.n) & ~3)


def test_flag_on_the_distributed_and_2d_formats():
    """The formats the other paths build carry the flag of their widths:
    a rank's slice, the overlap's reordered stripes (a ``col_out`` added),
    and the 2-D pack's 1-D view (computed on the device)."""
    B = vt.vbc1d(blocky_matrix(L=600), 8)
    for rank in range(3):
        assert vt.VBC1DDevice.from_host(shard_1d(B, 3, rank), "cpu").quad_widths
    moved = vt.VBC1DDevice.from_host(permute_stripes(B, np.arange(B.L)[::-1]), "cpu")
    assert dataclasses.replace(moved, col_out=torch.arange(B.n, dtype=torch.int32)
                               ).quad_widths
    for W, want in ((8, True), (6, False)):
        A = banded(200, 240, 6, 30, 7)
        B2 = vt.pack_vbc2d(vt.CSC.from_scipy(A), vt.SplitPartition.equi(200, 4),
                           vt.SplitPartition.equi(240, W), 4, W)
        view = vt.VBC2DDevice.from_host(B2, "cpu").view_1d()
        widths = np.diff(np.asarray(B2.Phi.spl))
        assert view.quad_widths is bool(np.all(widths % 4 == 0)) is want


@pytest.mark.parametrize("case", sorted(PACKS))
def test_column_sums_match_plain(case):
    B = PACKS[case][0]()
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(B.m).astype(F32), rng.standard_normal(B.n).astype(F32)
    got = column_sums(B, x, 0.5, 0.25, y)
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    want = vt.tr_spmv_plain(fmt, torch.from_numpy(x), 0.5, 0.25,
                            torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() <= TOL * max(1e-6, np.abs(want).max())


def test_column_sums_of_a_cut_are_the_whole_sums():
    """Ranks' slices (cut at stripe boundaries) and the stripes reordered
    give the whole pack's bits, column for column."""
    B = vt.vbc1d(banded(500, 480, 6, 50, 30), 8)
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal(B.m).astype(F32), rng.standard_normal(B.n).astype(F32)
    whole = column_sums(B, x, 0.5, 0.25, y)
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    ranges = split_ranges(np.diff(np.asarray(B.ofs, dtype=np.int64)), 3)
    for rank, (s0, s1) in enumerate(ranges):
        c0, c1 = spl[s0], spl[s1]
        got = column_sums(shard_1d(B, 3, rank, ranges), x, 0.5, 0.25, y[c0:c1])
        assert np.array_equal(got.view(np.int32), whole[c0:c1].view(np.int32))
    order = np.random.default_rng(3).permutation(B.L)
    cols = np.concatenate([np.arange(spl[s], spl[s + 1]) for s in order])
    got = column_sums(permute_stripes(B, order), x, 0.5, 0.25, y[cols])
    assert np.array_equal(got.view(np.int32), whole[cols].view(np.int32))


def staged_walk(B, x, alpha, beta, y_in, mis=0, words=STAGE_WORDS):
    """y as the staged map computes it (``csrc/trspmv.cu``:
    ``tr_spmv_staged_kernel``), its values ``mis`` words past a 16-byte
    boundary, on the runs ``stage_plan`` cuts at a stage of ``words``: the
    stage holds the run's (or the chunk's) values and x rows and nothing
    else, and a column reads only what was staged for it."""
    spl, pos, ofs = (np.asarray(a, dtype=np.int64) for a in (B.Phi.spl, B.pos, B.ofs))
    idx, val = np.asarray(B.idx, dtype=np.int64), np.asarray(B.val, dtype=F32)
    x = np.asarray(x, F32)
    runs = _cut_runs(*(torch.from_numpy(a) for a in (spl, pos, ofs)), STAGE_COLS,
                     STAGE_STRIPES, words).numpy()[:, 0].astype(np.int64)
    y = np.full(B.n, np.nan, F32)

    def window(w0, w1, mis):
        first = w0 - ((w0 + mis) & 3)
        end = w1 + ((4 - ((w1 + mis) & 3)) & 3)
        assert (first + mis) % 4 == 0 and (end - first) % 4 == 0
        return first, end

    def stage_rows(stage, at, cb, ce):
        """Block rows cb..ce-1's idx window copied to ``stage[at:]`` (16-byte
        aligned), then gathered: block cb's x at the returned word."""
        assert at % 4 == 0
        i0, i1 = window(cb, ce, (mis + 1) & 3)  # idx on another alignment
        assert at + (i1 - i0) <= words + 16, "the stage overflows"
        xs = at + (cb - i0)
        stage[xs:xs + ce - cb] = x[idx[cb:ce]]
        return xs

    def stage_of(cv0, cv1, cb, ce):
        a0, a1 = window(cv0, cv1, mis)
        stage = np.full(words + 16, np.nan, F32)
        lo, hi = max(a0, 0), min(a1, val.size)  # the rounding's words are unread
        stage[lo - a0:hi - a0] = val[lo:hi]
        return stage, a0, stage_rows(stage, a1 - a0, cb, ce) - cb

    def column(acc, stage, a0, xs, s0, s1, j, cb, ce):
        g = s0 + np.searchsorted(spl[s0:s1 + 1], j, side="right") - 1
        w = spl[g + 1] - spl[g]
        bl, bh = max(pos[g], cb), min(pos[g + 1], ce)
        sv = (ofs[g] - a0) + (bl - pos[g]) * w + (j - spl[g])
        for k in range(bh - bl):
            v, xv = stage[sv + k * w], stage[xs + bl + k]
            assert not (np.isnan(v) or np.isnan(xv)), "an unstaged word read"
            acc = fmaf(v, xv, acc)
        return acc

    def store(acc, j):
        y[j] = fmaf(F32(beta), F32(y_in[j]), (F32(alpha) * acc).astype(F32))

    for s0, s1 in zip(runs[:-1], runs[1:]):
        c0, c1, b0, b1, v0, v1 = spl[s0], spl[s1], pos[s0], pos[s1], ofs[s0], ofs[s1]
        if (v1 - v0) + (b1 - b0) <= words:  # staged once, passes of THREADS
            stage, a0, xs = stage_of(v0, v1, b0, b1)
            for j in range(c0, c1):
                store(column(F32(0), stage, a0, xs, s0, s1, j, b0, b1), j)
            continue
        assert s1 - s0 == 1, "a run longer than a stage holds one stripe"
        w = c1 - c0
        for jb in range(c0, c1, THREADS):
            pw = min(THREADS, c1 - jb)  # the pass's columns
            chunk = words // (pw + 1)
            assert chunk >= 1
            acc = np.zeros(pw, F32)
            for cb in range(b0, b1, chunk):
                ce = min(cb + chunk, b1)
                stage = np.full(words + 16, np.nan, F32)
                i = np.arange((ce - cb) * pw)
                r = i // pw  # as the kernel's copy loop
                at = v0 + (cb - b0 + r) * w + (jb - c0) + (i - r * pw)
                assert (at >= v0).all() and (at < v1).all()
                stage[:i.size] = val[at]
                xs = stage_rows(stage, (i.size + 3) & ~3, cb, ce)
                for t in range(pw):
                    for k in range(ce - cb):
                        v, xv = stage[k * pw + t], stage[xs + k]
                        assert not (np.isnan(v) or np.isnan(xv)), "an unstaged word read"
                        acc[t] = fmaf(v, xv, acc[t])
            for t in range(pw):
                store(acc[t], jb + t)
    return y


STAGED = {  # name -> (host pack, stage words): every kind of run
    **{name: (PACKS[name][0], STAGE_WORDS) for name in
       ("width_1", "width_3", "width_5", "width_40", "empty_stripes",
        "zero_width_stripe_odd", "multiclass_dp", "wide_rectangle")},
    "stripes_longer_than_a_stage": (lambda: vt.vbc1d(banded(300, 24, 200, 150, 5), 3,
                                                     vt.EquiChunker(3)), 256),
    "wider_than_a_block": (lambda: split_pack([0, 3, 1603, 1610], m=30), STAGE_WORDS),
    "long_and_wide": (lambda: split_pack([0, 300], m=120), 2048),
    "wider_than_a_stage": (lambda: split_pack([0, 2, 2302, 2305], m=30), 2048),
    "one_stripe": (lambda: split_pack([0, 7], m=50), STAGE_WORDS),
}


@pytest.mark.parametrize("mis", [0, 1, 3])
@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_walk_is_the_column_sums(case, mis):
    """Every column's bits as the thread a column's (``column_sums``), on
    values at each offset from a 16-byte boundary."""
    make, words = STAGED[case]
    B = make()
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal(B.m).astype(F32), rng.standard_normal(B.n).astype(F32)
    got = staged_walk(B, x, 0.5, 0.25, y, mis, words=words)
    want = column_sums(B, x, 0.5, 0.25, y)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
