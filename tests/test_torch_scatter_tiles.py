"""The scatter kernel's entry tiles (``ScatterDevice.tiles``), on the CPU.

``csrc/scatter.cu`` cuts a pack's entries into tiles of whole columns of
at most ``SCATTER_TILE`` entries (a warp each; a longer column fills
tiles of its own), gives each lane ``SCATTER_LANE_ENTRIES`` consecutive
entries, sums them by column with a segmented scan across the warp, and
finishes a long column from its tiles' sums in tile order.  The tile
layout is built on the host and with torch ops, so it is checked here: a
NumPy walk of the tiles, done as the kernel reads them (lane words, the
warp's keyed scan, the long columns' arrivals, the empty-column warps),
reproduces ``alpha * A.T @ x + beta * y`` on the three packs of
``chip_smoke.py`` that take the scatter route (the flagship's A.T, the
scattered matrix's A and A.T), on natural views of relabeled packs, and
on edge cases: a 10,000-entry column, empty columns, one column, entry
counts that fill the last tile or not, no entry at all.  Every entry is
read exactly once, every output written exactly once, and each tile
holds whole columns, as many as fit in ``SCATTER_TILE`` entries (a long
column's tiles hold ``SCATTER_TILE`` but its last).  The kernel itself
is held against its plain version on the card in ``test_torch_cuda.py``.

Tolerance: the walk sums in f64 (in the kernel's order) and must match
the f64 product to 1e-12 of max|y|.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.formats.device import SCATTER_LANE_ENTRIES, SCATTER_TILE
from vbcs_tpu_torch.ops.scatter import scatter_admits

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky_matrix, scattered_matrix  # noqa: E402
from chip_smoke import coo_matrix, empty_columns, long_column  # noqa: E402

E, TE = SCATTER_LANE_ENTRIES, SCATTER_TILE
TOL = 1e-12


def walk(fmt, x, alpha=None, beta=None, y=None):
    """``csrc/scatter.cu`` over ``fmt.tiles`` in f64 NumPy: returns y, the
    times each entry was read and the times each output was written."""
    t = fmt.tiles
    nnz, T = fmt.row.numel(), t.n_tiles
    _, q_tile, ta, tb = t.tiles.numpy().astype(np.int64).reshape(T, 4).T
    word = t.lanes.numpy()
    out = None if t.out is None else t.out.numpy().astype(np.int64)
    row = fmt.row.numpy().astype(np.int64)
    val = fmt.val.numpy().astype(np.float64)
    a = 1.0 if alpha is None else alpha
    with_y = beta is not None and y is not None
    res = np.zeros(fmt.n)
    writes = np.zeros(fmt.n, np.int64)

    def store(places, acc):
        places = np.asarray(places, dtype=np.int64)
        res[places] = a * np.asarray(acc) + (beta * y[places] if with_y else 0.0)
        np.add.at(writes, places, 1)

    def place(q):
        return q if out is None else out[q]

    # the lanes' words: first entry, q less the tile's, ends, entry count
    tile = np.arange(T * 32) // 32
    lane = np.arange(T * 32) % 32
    e = (word & 0xFFFFFFFF)[:, None] + np.arange(E)
    ends = (word >> 40) & 0xFF
    nv = (word >> 48) & 0xF
    valid = np.arange(E) < nv[:, None]
    reads = np.bincount(e[valid], minlength=nnz)
    q0 = q_tile[tile] + ((word >> 32) & 0xFF)
    endbit = ((ends[:, None] >> np.arange(E)) & 1).astype(bool) & valid
    ec = np.minimum(e, max(nnz - 1, 0))
    p = np.where(valid, val[ec] * x[row[ec]] if nnz else 0.0, 0.0)
    popc = np.array([bin(int(m)).count("1") for m in range(1 << E)])
    tail = np.zeros(T * 32)
    for k in range(E):
        tail = np.where(endbit[:, k], 0.0, tail + p[:, k])
    key = np.where(nv > 0, q0 + popc[ends], -1)
    # the warp's segmented inclusive scan, keyed by column
    s, kk = tail.reshape(T, 32).copy(), key.reshape(T, 32)
    for off in (1, 2, 4, 8, 16):
        so = np.zeros_like(s)
        so[:, off:] = s[:, :-off]
        ko = np.full_like(kk, -2)
        ko[:, off:] = kk[:, :-off]
        s = s + np.where(ko == kk, so, 0.0)
    carry = np.zeros_like(s)
    carry[:, 1:] = s[:, :-1]
    s, carry = s.reshape(-1), carry.reshape(-1)
    long_column = (ta != tb)[tile]
    arrivals = []  # (tile, first tile, last tile, q, its sum)
    acc = carry.copy()
    for k in range(E):
        acc = acc + p[:, k]
        q = q0 + popc[ends & ((1 << k) - 1)]
        done = endbit[:, k]
        store(place(q[done & ~long_column]), acc[done & ~long_column])
        for g in np.flatnonzero(done & long_column):
            arrivals.append((tile[g], ta[tile[g]], tb[tile[g]], q[g], acc[g]))
        acc = np.where(done, 0.0, acc)
    nv_next = np.append(nv[1:], 0)
    last = (nv > 0) & ((lane == 31) | (nv_next == 0))
    for g in np.flatnonzero(last & ~endbit[np.arange(T * 32), np.maximum(nv - 1, 0)]):
        assert long_column[g], "a tile of whole columns left one open"
        arrivals.append((tile[g], ta[tile[g]], tb[tile[g]], key[g], s[g]))
    # the last arrival at a long column's first tile adds the sums in order
    part = np.zeros(T)
    count = np.zeros(T, np.int64)
    for ti, t0, t1, q, v in arrivals:
        part[ti] = v
        count[t0] += 1
        if count[t0] == t1 - t0 + 1:
            total = part[t0]
            for s_ in range(t0 + 1, t1 + 1):
                total += part[s_]
            count[t0] = 0
            store([place(q)], [total])
    assert not count.any()
    store(t.empty.numpy(), np.zeros(t.empty.numel()))
    return res, reads, writes


def width1(A):
    return vt.ScatterDevice.from_host(vt.vbc1d(A, 8, vt.EquiChunker(1)), "cpu")


def flagship_at():
    B = vt.vbc1d(vt.CSC.from_scipy(blocky_matrix()).transpose(), 8)
    assert scatter_admits(B)
    return vt.ScatterDevice.from_host(B, "cpu")


def scattered(direction):
    A = vt.CSC.from_scipy(scattered_matrix().astype(np.float32))
    B = vt.vbc1d(A if direction == "A" else A.transpose(), 8)
    assert scatter_admits(B)
    return vt.ScatterDevice.from_host(B, "cpu")


def fits(entries):
    """A 700 x 700 matrix with exactly ``entries`` entries."""
    rng = np.random.default_rng(entries)
    n = 700
    flat = rng.choice(n * n, entries, replace=False)
    return coo_matrix(n, n, flat // n, flat % n, entries)


PACKS = {
    "flagship_A.T": flagship_at,
    "scattered_A": lambda: scattered("A"),
    "scattered_A.T": lambda: scattered("A.T"),
    "column_of_10000": lambda: width1(long_column()),
    "empty_columns": lambda: width1(empty_columns()),
    "one_column": lambda: width1(coo_matrix(900, 1, np.arange(0, 900, 2),
                                            np.zeros(450, int), 33)),
    "one_entry": lambda: width1(coo_matrix(5, 4, [3], [2], 34)),
    "no_entry": lambda: width1(sp.csc_matrix((6, 5), dtype=np.float32)),
    "ten_tiles_of_entries": lambda: width1(fits(10 * TE)),
    "ten_tiles_and_37": lambda: width1(fits(10 * TE + 37)),
}


def dense_product(fmt, x):
    row, col = (c.numpy() for c in fmt.value_coords)
    A = sp.csc_matrix((fmt.val.numpy().astype(np.float64), (row, col)),
                      shape=(fmt.m, fmt.n))
    return A.T @ x


def check_walk(fmt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(fmt.m)
    y = rng.standard_normal(fmt.n)
    want = dense_product(fmt, x)
    scale = max(1e-300, np.abs(want).max(initial=0.0), 1.0)
    for args, ref in (((), want), ((0.5, -0.25, y), 0.5 * want - 0.25 * y)):
        got, reads, writes = walk(fmt, x, *args)
        assert np.all(reads == 1), "an entry not read exactly once"
        assert np.all(writes == 1), "an output not written exactly once"
        assert np.abs(got - ref).max(initial=0.0) <= TOL * scale


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_walk_reproduces_the_product(pack):
    check_walk(PACKS[pack](), 1)


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_tile_layout(pack):
    fmt = PACKS[pack]()
    t = fmt.tiles
    nnz, T = fmt.row.numel(), t.n_tiles
    assert t.tiles.dtype == torch.int32 and t.tiles.shape == (T, 4)
    assert t.lanes.dtype == torch.int64 and t.lanes.shape == (32 * T,)
    assert t.scratch.dtype == torch.int32 and t.scratch.numel() == 2 * T
    assert not t.scratch.any()
    start, q_tile, ta, tb = t.tiles.numpy().astype(np.int64).T
    end = np.append(start[1:], nnz)[:T]
    # the tiles cover the entries in order, each with 1..SCATTER_TILE
    assert T == 0 or start[0] == 0
    size = end - start
    assert np.all((size > 0) & (size <= TE))
    # whole columns, but a column longer than a tile, which fills tiles of
    # its own (SCATTER_TILE entries but its last)
    cnt = np.diff(fmt.colptr.numpy().astype(np.int64))
    bounds = set(fmt.colptr.numpy().tolist())
    mine = ta == tb
    np.testing.assert_array_equal(ta[mine], np.flatnonzero(mine))
    assert all(int(b) in bounds for b in np.concatenate([start[mine], end[mine]]))
    for t0, t1 in set(zip(ta[~mine].tolist(), tb[~mine].tolist())):
        assert start[t0] in bounds and end[t1] in bounds and t1 > t0
        assert np.all(size[t0:t1] == TE) and size[t1] <= TE
        np.testing.assert_array_equal(ta[t0:t1 + 1], t0)
        assert size[t0:t1 + 1].sum() > TE
    # greedy: a tile of whole columns could not take the next one
    nz_start = fmt.colptr.numpy().astype(np.int64)[:-1][cnt > 0]
    nz_len = cnt[cnt > 0]
    for t_ in np.flatnonzero(mine[:-1]):
        nxt = np.searchsorted(nz_start, end[t_])
        assert size[t_] + nz_len[nxt] > TE
    # a lane's word: its first entry, that entry's column ordinal less the
    # tile's first, a bit for each entry that ends its column, its count
    q_of = np.repeat(np.arange(nz_len.size), nz_len)
    if T:
        np.testing.assert_array_equal(q_tile, q_of[start])
    word = t.lanes.numpy()
    first = (start[:, None] + E * np.arange(32)).reshape(-1)
    stop = np.repeat(end, 32)
    live = first < stop
    np.testing.assert_array_equal(word[live] & 0xFFFFFFFF, first[live])
    np.testing.assert_array_equal(((word >> 32) & 0xFF)[live],
                                  q_of[first[live]] - np.repeat(q_tile, 32)[live])
    np.testing.assert_array_equal(word >> 48, np.clip(stop - first, 0, E))
    pos = first[:, None] + np.arange(E)
    ends_at = np.zeros(nnz + E * 32, bool)
    ends_at[np.flatnonzero(np.diff(np.append(q_of, -1)) != 0)] = True
    want = ends_at[pos] & (pos < stop[:, None])
    np.testing.assert_array_equal((word >> 40)[:, None] >> np.arange(E) & 1, want)
    # the output places: natural columns, nonempty ones then empty ones
    nz, em = np.flatnonzero(cnt > 0), np.flatnonzero(cnt == 0)
    if t.out is None:
        assert em.size == 0
    else:
        np.testing.assert_array_equal(t.out.numpy(), nz)
    np.testing.assert_array_equal(t.empty.numpy(), em)
    assert t.nbytes == 16 * T + 8 * t.lanes.numel() + 4 * (
        (0 if t.out is None else t.out.numel()) + em.size)


@pytest.mark.parametrize("pack", ["scattered_A", "empty_columns",
                                  "column_of_10000"])
def test_walk_on_a_natural_view(pack):
    """A relabeled square pack's natural view: the tiles place each column
    at perm of it (the empty ones too) and read natural x."""
    fmt = PACKS[pack]()
    if fmt.m != fmt.n:  # square it up with an empty block
        n = max(fmt.m, fmt.n)
        fmt = vt.ScatterDevice(
            m=n, n=n, row=fmt.row, val=fmt.val,
            colptr=torch.cat([fmt.colptr, fmt.colptr[-1:].expand(n - fmt.n)]))
    perm = torch.from_numpy(
        np.random.default_rng(5).permutation(fmt.n).astype(np.int32))
    view = fmt.natural_view(perm)
    assert view.tiles.out is not None
    cnt = np.diff(fmt.colptr.numpy())
    np.testing.assert_array_equal(view.tiles.empty.numpy(),
                                  perm.numpy()[cnt == 0])
    check_walk(view, 2)


def test_tiles_are_built_once():
    fmt = PACKS["one_column"]()
    assert fmt.tiles is fmt.tiles
