"""The SpMM kernel's thread maps, batches, width classes and sum order
(``csrc/spmm.cu``), in NumPy, and the pack fields that steer it.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``).  Here
:func:`walk` follows its launch as the source reads: the first
``n_long * long_tiles`` thread blocks each take a long stripe's k-tile
(chunks of ``C`` blocks whose idx, values and X rows the block's threads
stage in shared memory by the kernel's own index arithmetic, then thread
``(i, q)`` adds them), the rest the short map (a group of ``G`` lanes a
(stripe, k-tile) item, ``kW`` stripe columns a pass, ``kBatch`` blocks a
batch).  With the plain version's arithmetic (an f32 product, then an f32
add, in block order) the walk must give ``tr_spmm_plain``'s bits: every
output written once, from its blocks in order.  With ``fmaf`` (the
kernel's) its bits must not depend on the class, the batch, the long path
or a cut of the pack at stripe boundaries, and must equal the slice-2
kernel's order (each output's blocks in order from 0); it must agree with
the JAX SpMM kernels in interpret mode within ``TOL`` (f32 sums in
another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_spmm as pm
from vbcs_tpu.ops import pallas_spmm3 as sm3
from vbcs_tpu.ops import pallas_spmm4 as pm4
from vbcs_tpu.ops import pallas_trspmv as pk1
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import pallas_trspmv3 as pk3
from vbcs_tpu_torch.formats.device import SPMM_LONG_BLOCKS, WIDTH_CLASSES, width_class
from vbcs_tpu_torch.parallel.shard import permute_stripes, shard_1d, split_ranges
from vbcs_tpu_torch.tools.matrices import blocky_matrix

F32 = np.float32
TOL = 2e-5  # against the JAX kernels and the f64 product: f32 sums in another order
KS = (1, 3, 4, 5, 31, 32, 33, 128, 130)
# the kernel's constants (csrc/spmm.cu)
THREADS, CHUNK_QUADS, CHUNK_MAX, LONG_COLS = 256, 2048, 256, 8
DEEP_BLOCKS = 16  # kDeepBlocks: class 8 pipes from this mean of blocks a stripe


def batch_of(width, deep, vec):
    return 4 if width == 4 or (width == 8 and deep) else 1 if width == 8 and not vec else 2
NO_LONG = 2**31 - 1


def plain_add(a, x, acc):
    """``tr_spmm_plain``'s arithmetic: an f32 product, then an f32 add
    (``a`` one value, or one a row of ``x``)."""
    a = np.asarray(a, F32)[..., None]
    return (acc + (a * x).astype(F32)).astype(F32)


def fmaf(a, x, acc):
    a = np.asarray(a, np.float64)[..., None]
    return (a * x.astype(np.float64) + acc.astype(np.float64)).astype(F32)


def launch_plan(k):
    """(log2 G, Q, long k-tiles, C) as ``vbcs_tr_spmm`` sets them."""
    lg = 0
    while lg < 5 and (4 << lg) < k:
        lg += 1
    Q = 32 if k >= 128 else (k + 3) // 4
    return lg, Q, -(-k // (4 * Q)), min(CHUNK_MAX, CHUNK_QUADS // Q)


def row4(X, r, c):
    """X[r, c:c+4] with the columns past k read as 0 (the masked loads)."""
    out = np.zeros(4, F32)
    hi = min(4, X.shape[1] - c)
    out[:hi] = X[r, c:c + hi]
    return out


def walk(fmt, X, madd=fmaf, width=None, longs=None, long_blocks=None):
    """Y as the kernel computes it on ``fmt`` (a VBC1DDevice on the CPU),
    and the number of writes of each output."""
    spl, pos, idx, ofs = (t.numpy().astype(np.int64) for t in
                          (fmt.spl, fmt.pos, fmt.idx, fmt.ofs))
    val = fmt.val.numpy()
    col_out = None if fmt.col_out is None else fmt.col_out.numpy()
    width = fmt.width_class if width is None else width
    if longs is None:
        longs = fmt.long_stripes.numpy()
        long_blocks = SPMM_LONG_BLOCKS
    n, k = fmt.n, X.shape[1]
    Y = np.full((n, k), np.nan, F32)
    writes = np.zeros((n, k), np.int64)

    def put(j, c, acc):
        jo = j if col_out is None else col_out[j]
        hi = min(4, k - c)
        Y[jo, c:c + hi] = acc[:hi]
        writes[jo, c:c + hi] += 1

    lg, Q, long_tiles, C = launch_plan(k)
    for s in longs:  # the long stripes' thread blocks
        j0, w = spl[s], spl[s + 1] - spl[s]
        b0, b1 = pos[s], pos[s + 1]
        for tile in range(long_tiles):
            c_base = tile * 4 * Q
            for g0 in range(0, w, LONG_COLS):
                gw = min(LONG_COLS, w - g0)
                acc = np.zeros((THREADS, 4), F32)
                for cb in range(b0, b1, C):
                    nb = min(C, b1 - cb)
                    ids = np.full(C, -1, np.int64)
                    ids[:nb] = idx[cb:cb + nb]  # threads tid < nb
                    vsm = np.full(LONG_COLS * C, np.nan, F32)
                    e = np.arange(THREADS * LONG_COLS)  # tid + r * THREADS
                    u = e // gw
                    on = u < nb
                    vsm[u[on] * LONG_COLS + (e - u * gw)[on]] = val[
                        ofs[s] + (cb - b0 + u[on]) * w + g0 + (e - u * gw)[on]]
                    xs = np.full((C * Q, 4), np.nan, F32)
                    e = np.arange(CHUNK_QUADS)
                    u = e // Q
                    cc = c_base + 4 * (e - u * Q)
                    for e1 in np.flatnonzero((u < nb) & (cc < k)):
                        xs[e1] = row4(X, ids[u[e1]], cc[e1])
                    tid = np.arange(THREADS)
                    i, q = tid // Q, tid % Q
                    mine = (i < gw) & (c_base + 4 * q < k)
                    for u in range(nb):
                        acc[mine] = madd(vsm[u * LONG_COLS + i[mine]],
                                         xs[u * Q + q[mine]], acc[mine])
                for t in np.flatnonzero(mine):
                    put(j0 + g0 + i[t], c_base + 4 * q[t], acc[t])
    G = 1 << lg
    batch = batch_of(width, fmt.idx.numel() >= DEEP_BLOCKS * fmt.L, k % 4 == 0)
    for item in range(fmt.L * -(-k // (4 * G))):  # the short map's items
        s = item % fmt.L
        b0, b1 = pos[s], pos[s + 1]
        if b1 - b0 > (NO_LONG if long_blocks is None else long_blocks):
            continue
        j0, w = spl[s], spl[s + 1] - spl[s]
        for lane in range(G):
            c0 = (item // fmt.L) * 4 * G + 4 * lane
            if c0 >= k:
                continue
            for g0 in range(0, w, width):
                gw = min(width, w - g0)
                acc = np.zeros((width, 4), F32)
                for b in range(b0, b1, batch):
                    for u in range(batch):
                        if b + u < b1:
                            x = row4(X, idx[b + u], c0)
                            for i in range(gw):
                                a = val[ofs[s] + (b + u - b0) * w + g0 + i]
                                acc[i] = madd(a, x, acc[i])
                for i in range(gw):
                    put(j0 + g0 + i, c0, acc[i])
    return Y, writes


def slice2_order(fmt, X):
    """The slice-2 kernel's bits: each output its stripe's blocks in order,
    ``fmaf`` from 0 (one 8-column tile, two blocks a step: the same order)."""
    spl, pos, idx, ofs = (t.numpy().astype(np.int64) for t in
                          (fmt.spl, fmt.pos, fmt.idx, fmt.ofs))
    val = fmt.val.numpy()
    Y = np.zeros((fmt.n, X.shape[1]), F32)
    for s in range(fmt.L):
        w = spl[s + 1] - spl[s]
        for i in range(w):
            acc = np.zeros(X.shape[1], F32)
            for b in range(pos[s], pos[s + 1]):
                acc = fmaf(val[ofs[s] + (b - pos[s]) * w + i], X[idx[b]], acc)
            j = spl[s] + i
            Y[j if fmt.col_out is None else fmt.col_out[j]] = acc
    return Y


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    vals = rng.standard_normal(n * d).astype(F32)
    A = sp.coo_matrix((vals, (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def long_matrix(w=3, seed=8, n=None):
    """330 x n (8 stripes of width w by default): the first two stripes
    dense over 330 and 300 rows (long: more than SPMM_LONG_BLOCKS blocks,
    six and five chunks at k = 128), the rest banded; one empty stripe."""
    A = banded(330, n or 8 * w, 4, 20, seed).tolil()
    rng = np.random.default_rng(seed)
    A[:, :w] = rng.standard_normal((330, w)).astype(F32)
    A[30:, w:2 * w] = rng.standard_normal((300, w)).astype(F32)
    A[:, 5 * w:6 * w] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return A


def long_pack(w=3, seed=8):
    return vt.vbc1d(long_matrix(w, seed), w, vt.EquiChunker(w))


def empty_stripes_pack():
    A = banded(300, 64, 12, 60, 21).tolil()
    A[:, 16:32] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return vt.vbc1d(A, 8, vt.EquiChunker(8))


PACKS = {
    **{f"width_{w}": (lambda w=w: vt.vbc1d(banded(90, 3 * w, 30, 40, w), w,
                                          vt.EquiChunker(w)))
       for w in (1, 2, 3, 4, 5, 8, 16, 40)},
    "empty_stripes": empty_stripes_pack,
    "multiclass_dp": lambda: vt.vbc1d(
        banded(160, 96, 5, 40, 12), 4,
        vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4)),
    "long_w3": long_pack,
    "long_w8": lambda: long_pack(8, 9),
}


def natural_view(B):
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    perm = np.random.default_rng(4).permutation(fmt.n).astype(np.int32)
    return fmt.natural_view(torch.from_numpy(perm))


def rhs(rows, k, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(F32)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", sorted(PACKS) + ["natural_view"])
def test_walk_is_plain_bitwise(case, k):
    """Every output written once, its blocks added in order: with the
    plain version's arithmetic the walk is ``tr_spmm_plain`` bit for bit."""
    if case == "natural_view":
        fmt = natural_view(vt.vbc1d(banded(120, 120, 6, 20, 5), 4))
    else:
        fmt = vt.VBC1DDevice.from_host(PACKS[case](), "cpu")
    X = rhs(fmt.m, k, k)
    Y, writes = walk(fmt, X, plain_add)
    assert (writes[np.arange(fmt.n) if fmt.col_out is None
                   else fmt.col_out.numpy()] == 1).all()
    want = vt.tr_spmm_plain(fmt, torch.from_numpy(X)).numpy()
    assert np.array_equal(Y.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k", (5, 32, 128))
@pytest.mark.parametrize("case", ["width_3", "width_40", "multiclass_dp",
                                  "long_w3", "long_w8"])
def test_bits_do_not_depend_on_class_batch_or_long_path(case, k):
    """With ``fmaf``: every width class, and the long path on or off, give
    the slice-2 kernel's bits."""
    fmt = vt.VBC1DDevice.from_host(PACKS[case](), "cpu")
    X = rhs(fmt.m, k, 1)
    want = slice2_order(fmt, X).view(np.int32)
    for width in WIDTH_CLASSES:
        assert np.array_equal(walk(fmt, X, width=width)[0].view(np.int32), want)
    none = walk(fmt, X, longs=np.zeros(0, np.int64), long_blocks=NO_LONG)[0]
    assert np.array_equal(none.view(np.int32), want)


def test_bits_of_a_cut_are_the_whole_bits():
    """Ranks' slices (cut at stripe boundaries, ``dist_tr_spmm``'s) and the
    stripes reordered give the whole pack's rows, bit for bit."""
    B = long_pack(4, 3)
    X = rhs(B.m, 32, 2)
    whole = walk(vt.VBC1DDevice.from_host(B, "cpu"), X)[0]
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    ranges = split_ranges(np.diff(np.asarray(B.ofs, dtype=np.int64)), 3)
    for rank, (s0, s1) in enumerate(ranges):
        got = walk(vt.VBC1DDevice.from_host(shard_1d(B, 3, rank, ranges), "cpu"), X)[0]
        assert np.array_equal(got.view(np.int32),
                              whole[spl[s0]:spl[s1]].view(np.int32))
    order = np.random.default_rng(3).permutation(B.L)
    cols = np.concatenate([np.arange(spl[s], spl[s + 1]) for s in order])
    got = walk(vt.VBC1DDevice.from_host(permute_stripes(B, order), "cpu"), X)[0]
    assert np.array_equal(got.view(np.int32), whole[cols].view(np.int32))


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pm, sm3, pm4, pk1, pk2, pk3):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("k", [32, 128])
def test_walk_matches_spmm4(k, interpret_mode):
    A = blocky_matrix(L=48, band=40).astype(F32)
    B = v.vbc1d(A, 8, v.EquiChunker(8))
    fmt4 = pm4.pack_spmm4(B, sl=8)
    assert fmt4 is not None
    X = rhs(A.shape[0], k, 7)
    Yj = np.asarray(pm4.tr_spmm_pallas4(fmt4, jnp.asarray(X)))
    Y = walk(vt.VBC1DDevice.from_host(B, "cpu"), X)[0]
    assert rel_err(Y, Yj) <= TOL
    assert rel_err(Y, A.T.astype(np.float64) @ X) <= TOL


def test_walk_matches_spmm3(interpret_mode):
    A = banded(128, 128, 6, 40, seed=11)
    B = v.vbc1d(A, 8, v.EquiChunker(8))
    fmt3 = pk3.pack_stream3(B, mode="nat")
    assert fmt3 is not None and len(fmt3.ws) == 1
    X = rhs(A.shape[0], 33, 9)
    Yj = np.asarray(sm3.tr_spmm_pallas3(fmt3, jnp.asarray(X)))
    assert rel_err(walk(vt.VBC1DDevice.from_host(B, "cpu"), X)[0], Yj) <= TOL


def test_walk_matches_spmm_v2_on_long_stripes(interpret_mode):
    """The JAX v2 SpMM (any plan) on a pack whose first stripes take the
    long path."""
    A = long_matrix(4, 5)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, 4, vt.EquiChunker(4)), "cpu")
    assert fmt.long_stripes.numel() == 2
    X = rhs(A.shape[0], 5, 8)
    Yj = np.asarray(pm.tr_spmm_pallas(pk2.pack_stream2(v.vbc1d(A, 4, v.EquiChunker(4))),
                                      jnp.asarray(X)))
    Y = walk(fmt, X)[0]
    assert rel_err(Y, Yj) <= TOL
    assert rel_err(Y, A.T.astype(np.float64) @ X) <= TOL


@pytest.mark.parametrize("widths,nblk,want", [
    ([1] * 10, [5] * 10, 1),
    ([1] * 16 + [2], [4] * 17, 1),     # 4 re-read blocks of 68: <= 1/16
    ([1] * 10 + [2], [4] * 11, 2),     # 4 of 44: > 1/16
    ([2, 2, 3], [8, 8, 8], 4),
    ([8, 1, 1], [0, 9, 9], 1),         # a wide empty stripe costs nothing
    ([5, 8, 40], [3, 3, 3], 8),
    ([], [], 1),
])
def test_width_class_rule(widths, nblk, want):
    assert width_class(np.array(widths, np.int64), np.array(nblk, np.int64)) == want


def test_pack_fields_on_every_format():
    """``width_class`` and ``long_stripes`` on a pack, its natural view, a
    rank's slice and the 2-D pack's 1-D view (built on the device)."""
    B = long_pack()
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    nb = np.diff(np.asarray(B.pos))
    assert fmt.width_class == width_class(np.diff(np.asarray(B.Phi.spl)), nb) == 4
    assert fmt.long_stripes.dtype == torch.int32
    assert fmt.long_stripes.tolist() == np.flatnonzero(nb > SPMM_LONG_BLOCKS).tolist()
    assert fmt.nbytes - dataclasses.replace(fmt, long_stripes=None).nbytes == 8
    square = vt.VBC1DDevice.from_host(
        vt.vbc1d(long_matrix(n=330), 3, vt.EquiChunker(3)), "cpu")
    perm = torch.from_numpy(np.random.default_rng(4).permutation(330).astype(np.int32))
    view = square.natural_view(perm)
    assert view.width_class == square.width_class
    assert view.long_stripes is square.long_stripes and view.long_stripes.numel() == 2
    found = 0
    for rank in range(2):
        sl = vt.VBC1DDevice.from_host(shard_1d(B, 2, rank), "cpu")
        nb = np.diff(sl.pos.numpy())
        assert sl.long_stripes.tolist() == np.flatnonzero(nb > SPMM_LONG_BLOCKS).tolist()
        found += sl.long_stripes.numel()
    assert found == 2
    A = banded(200, 240, 6, 30, 7)
    B2 = vt.pack_vbc2d(vt.CSC.from_scipy(A), vt.SplitPartition.equi(200, 4),
                       vt.SplitPartition.equi(240, 8), 4, 8)
    view = vt.VBC2DDevice.from_host(B2, "cpu").view_1d()
    nb = np.diff(view.pos.numpy())
    assert view.width_class == width_class(np.diff(np.asarray(B2.Phi.spl)), nb)
    assert view.long_stripes.tolist() == np.flatnonzero(nb > SPMM_LONG_BLOCKS).tolist()


def test_flagship_packs_classes():
    """The flagship's A pack (width 8) and its A.T pack (mean width 1.17,
    2.4% of its blocks in stripes wider than 1) at L = 2,000."""
    op = vt.VBCOperator.from_csc(blocky_matrix(L=2000), W=8, device="cpu")
    assert (op.nat_tr.width_class, op.nat_fw.width_class) == (8, 1)
    assert op.nat_tr.long_stripes.numel() == 0
