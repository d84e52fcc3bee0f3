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
