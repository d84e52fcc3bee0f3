"""Sharding and halo planning for the distributed paths, on the host.

Counterpart of the planning halves of ``vbcs_tpu/parallel/``: the stripe
ranges (``pallas_spmv.py:_split_ranges``, ``pallas_spmv3.py:_shard_ranges``),
the column slice ``pallas_spmv3.py:shard_oneshot3`` cuts before it packs,
the halo plan (``pallas_spmv.py:HaloPlan``, ``plan_halo``) and the
overlap order (``pallas_spmv.py:plan_overlap``).  Every function is
NumPy and deterministic, so each rank plans the whole matrix and keeps
its own part; no rank waits on another to plan.

A shard is a contiguous range of the pack's stripes: a column slice
``A[:, c0:c1]`` as a ``VBC1D`` or ``VBC2D`` of its own (rows unchanged).
The JAX package cut chunk streams at carry-free chunk boundaries; the
port's formats have no carries, so every stripe boundary is a cut.

``x`` is sharded in aligned ``TILE``-row tiles, ``tiles_per_dev =
ceil(ceil(m / TILE) / ndev)`` a rank, as the JAX plan does.  A rank needs
the tiles its stored rows fall in (for a 2-D pack every row of each
tile, ``tile_row .. tile_row + u - 1``).  Every (source, dest) pair
sends the tiles dest needs from source, padded to the worst pair
``hmax``, so one ``all_to_all_single`` of equal splits moves the halo.
The rank's *pool* holds the tiles it needs in global tile order, and a
2-D shard's rows are rewritten into pool coordinates
(:meth:`HaloPlan.to_pool`): a tile whose rows straddle two x tiles finds
both next to each other in the pool, wherever they came from.  A 1-D
shard's block rows are rewritten into the stage's coordinates
(:meth:`HaloPlan.to_stage`), so its kernel reads the stage as the
exchange left it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.partition import SplitPartition
from ..formats.vbc1d import VBC1D
from ..formats.vbc2d import VBC2D

__all__ = ["TILE", "tiles_per_dev", "split_ranges", "even_ranges",
           "stored_per_stripe", "shard_1d", "shard_2d", "HaloPlan",
           "plan_halo", "plan_overlap", "permute_stripes", "stripe_columns"]

TILE = 1024  # rows of x a halo tile holds (the JAX plan's aligned tile)


def tiles_per_dev(m: int, ndev: int) -> int:
    """x tiles each rank owns: ``ceil(ceil(m / TILE) / ndev)``."""
    return -(-max(1, -(-m // TILE)) // ndev)


def split_ranges(cost, ndev: int) -> list[tuple[int, int]]:
    """Contiguous stripe ranges, one a rank, balancing cumulative ``cost``
    (one entry a stripe): rank ``d``'s range ends at the stripe boundary
    nearest ``d / ndev`` of the total, short of the last.  The JAX
    ``_split_ranges`` with every boundary allowed (a zero cost counts as
    1e-9, as there)."""
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    cost = np.maximum(np.asarray(cost, dtype=np.float64), 1e-9)
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    cuts = cum[:max(1, cost.size)]  # as there, a cut leaves the last stripe
    bounds = [0]
    for d in range(1, ndev):
        k = int(np.argmin(np.abs(cuts - cum[-1] * d / ndev)))
        bounds.append(max(k, bounds[-1]))
    bounds.append(cost.size)
    return [(bounds[d], bounds[d + 1]) for d in range(ndev)]


def even_ranges(S: int, ndev: int) -> list[tuple[int, int]]:
    """Contiguous near-equal stripe ranges (sizes differ by at most 1)."""
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    cuts = [(S * d) // ndev for d in range(ndev + 1)]
    return [(cuts[d], cuts[d + 1]) for d in range(ndev)]


def stored_per_stripe(B) -> np.ndarray:
    """Stored values (block fill included) of each stripe of a 1-D or 2-D pack."""
    return np.diff(np.asarray(B.ofs, dtype=np.int64))


def _checked(ranges, S: int, ndev: int, rank: int):
    ranges = [(int(a), int(b)) for a, b in ranges]
    if len(ranges) != ndev or not 0 <= rank < ndev:
        raise ValueError(f"need {ndev} ranges and 0 <= rank < {ndev}")
    if ranges[0][0] != 0 or ranges[-1][1] != S or any(
            a > b for a, b in ranges) or any(
            ranges[d][1] != ranges[d + 1][0] for d in range(ndev - 1)):
        raise ValueError(f"stripe ranges {ranges} do not cover [0, {S}) in order")
    return ranges[rank]


def shard_1d(B, ndev: int, rank: int, ranges=None) -> VBC1D:
    """Rank ``rank``'s column slice of a host 1-D pack (this port's
    ``VBC1D`` or the JAX package's): stripes ``ranges[rank]`` with ``spl``,
    ``pos`` and ``ofs`` rebased, rows unchanged (``m`` is ``B.m``).
    ``ranges`` defaults to :func:`split_ranges` over the stored values."""
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    if ranges is None:
        ranges = split_ranges(stored_per_stripe(B), ndev)
    s0, s1 = _checked(ranges, spl.size - 1, ndev, rank)
    pos = np.asarray(B.pos)
    ofs = np.asarray(B.ofs)
    p0, p1, o0, o1 = int(pos[s0]), int(pos[s1]), int(ofs[s0]), int(ofs[s1])
    return VBC1D(
        m=int(B.m), n=int(spl[s1] - spl[s0]), W=int(B.W),
        Phi=SplitPartition(spl[s0:s1 + 1] - spl[s0]),
        pos=pos[s0:s1 + 1] - pos.dtype.type(p0), idx=np.asarray(B.idx)[p0:p1],
        ofs=ofs[s0:s1 + 1] - ofs.dtype.type(o0), val=np.asarray(B.val)[o0:o1])


def shard_2d(B2, ndev: int, rank: int, ranges=None) -> VBC2D:
    """Rank ``rank``'s column slice of a host 2-D pack, as :func:`shard_1d`:
    the row partition ``Pi`` is kept whole."""
    spl = np.asarray(B2.Phi.spl, dtype=np.int64)
    if ranges is None:
        ranges = split_ranges(stored_per_stripe(B2), ndev)
    s0, s1 = _checked(ranges, spl.size - 1, ndev, rank)
    pos = np.asarray(B2.pos)
    ofs = np.asarray(B2.ofs)
    p0, p1, o0, o1 = int(pos[s0]), int(pos[s1]), int(ofs[s0]), int(ofs[s1])
    return VBC2D(
        m=int(B2.m), n=int(spl[s1] - spl[s0]), U=int(B2.U), W=int(B2.W),
        Pi=SplitPartition(np.asarray(B2.Pi.spl)),
        Phi=SplitPartition(spl[s0:s1 + 1] - spl[s0]),
        pos=pos[s0:s1 + 1] - pos.dtype.type(p0), idx=np.asarray(B2.idx)[p0:p1],
        ofs=ofs[s0:s1 + 1] - ofs.dtype.type(o0), val=np.asarray(B2.val)[o0:o1])


def _row_spans(B, s0: int, s1: int) -> tuple[np.ndarray, np.ndarray]:
    """First and last row (inclusive) of each block (1-D) or tile (2-D) of
    stripes ``[s0, s1)``; 2-D tiles of height 0 are left out."""
    pos = np.asarray(B.pos, dtype=np.int64)
    idx = np.asarray(B.idx, dtype=np.int64)[pos[s0]:pos[s1]]
    if not hasattr(B, "Pi"):
        return idx, idx
    rspl = np.asarray(B.Pi.spl, dtype=np.int64)
    first, last = rspl[idx], rspl[idx + 1] - 1
    keep = last >= first
    return first[keep], last[keep]


def _tiles_read(B, s0: int, s1: int) -> np.ndarray:
    """Sorted x tiles the stripes ``[s0, s1)`` read."""
    first, last = _row_spans(B, s0, s1)
    t0, t1 = first // TILE, last // TILE
    span = t1 - t0 + 1
    if span.size and int(span.max()) == 1:
        return np.unique(t0)
    return np.unique(np.repeat(t0, span) + _ramps(span))


def _ramps(lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(k) for k in lengths])``."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The static halo exchange of a sharded pack (``pallas_spmv.py:708``).

    ``send[s, d, :counts[s, d]]`` are the tiles rank ``d`` needs from rank
    ``s``, as ``s``-local tile ids (``tile - s * tiles_per_dev``); the rest
    of each row of ``hmax`` is padding (tile 0), and ``counts[d, d]`` is 0.
    After the exchange rank ``d`` holds a *stage*, its own tiles then
    ``ndev * hmax`` received ones by source; its pool is the tiles in
    ``needed[d]`` in global order, ``stage[pool_src(d)]``.  A 1-D shard
    reads the stage itself (:meth:`to_stage`), a 2-D one the pool
    (:meth:`to_pool`)."""

    m: int
    ndev: int
    tiles_per_dev: int
    hmax: int
    needed: tuple  # per rank: sorted int64 x tiles its shard reads
    send: np.ndarray  # [ndev (source), ndev (dest), hmax] int64 source-local ids
    counts: np.ndarray  # [ndev (source), ndev (dest)] real tiles sent

    def received(self, rank: int) -> int:
        """Tiles rank ``rank`` receives (padding not counted)."""
        return int(self.counts[:, rank].sum())

    def own_rows(self, rank: int) -> tuple[int, int]:
        """Rows ``[lo, hi)`` of x that rank ``rank`` owns (``hi - lo`` may be
        less than ``tiles_per_dev * TILE`` at the end of x, or 0)."""
        lo = min(self.m, rank * self.tiles_per_dev * TILE)
        return lo, min(self.m, lo + self.tiles_per_dev * TILE)

    @property
    def stage_rows(self) -> int:
        """Rows of a rank's stage: its own tiles, then ``ndev * hmax``."""
        return (self.tiles_per_dev + self.ndev * self.hmax) * TILE

    def pool_src(self, rank: int) -> np.ndarray:
        """Where each pool tile of rank ``rank`` sits in its stage."""
        tpd, pool = self.tiles_per_dev, self.needed[rank]
        src = pool // tpd
        out = pool - rank * tpd  # own tiles: their place among the own
        # received tiles: by source, in the order the source sent them
        for s in np.unique(src[src != rank]):
            sel = src == s
            out[sel] = tpd + s * self.hmax + np.arange(int(sel.sum()))
        return out

    def to_pool(self, rank: int, rows: np.ndarray) -> np.ndarray:
        """Rows of x (each in a tile rank ``rank`` needs) in its pool's
        coordinates; raises if a row's tile is not in the pool."""
        rows = np.asarray(rows, dtype=np.int64)
        pool = self.needed[rank]
        t = rows // TILE
        p = np.searchsorted(pool, t)
        if rows.size and (int(p.max()) >= pool.size
                          or not np.array_equal(pool[p], t)):
            raise ValueError("a row outside the rank's pool")
        return p * TILE + rows % TILE

    def to_stage(self, rank: int, rows: np.ndarray) -> np.ndarray:
        """Rows of x (each in a tile rank ``rank`` needs) at their place in
        its stage (``pool_src``); raises as :meth:`to_pool`."""
        p = self.to_pool(rank, rows)
        return self.pool_src(rank)[p // TILE] * TILE + p % TILE


def plan_halo(B, ndev: int, ranges=None) -> HaloPlan:
    """The halo plan of a 1-D or 2-D host pack sharded by ``ranges``
    (default :func:`split_ranges` over the stored values): which x tiles
    each rank reads, and what each pair sends (``hmax`` at least 1, as in
    the JAX plan)."""
    S = np.asarray(B.Phi.spl).size - 1
    if ranges is None:
        ranges = split_ranges(stored_per_stripe(B), ndev)
    m = int(B.m)
    tpd = tiles_per_dev(m, ndev)
    needed = tuple(_tiles_read(B, *_checked(ranges, S, ndev, d))
                   for d in range(ndev))
    counts = np.zeros((ndev, ndev), dtype=np.int64)
    for d in range(ndev):
        src = needed[d] // tpd
        counts[:, d] = np.bincount(src[src != d], minlength=ndev)
    hmax = max(1, int(counts.max(initial=0)))
    send = np.zeros((ndev, ndev, hmax), dtype=np.int64)
    for d in range(ndev):
        src = needed[d] // tpd
        for s in range(ndev):
            if s != d:
                tiles = needed[d][src == s]
                send[s, d, :tiles.size] = tiles - s * tpd
    return HaloPlan(m=m, ndev=ndev, tiles_per_dev=tpd, hmax=hmax,
                    needed=needed, send=send, counts=counts)


def plan_overlap(B, halo: HaloPlan, rank: int, ranges=None):
    """Rank ``rank``'s stripes with the *local* ones first (every row in its
    own x tiles; an empty stripe is local), each group in pack order:
    ``(order, k_local)``, ``order`` relative to the rank's first stripe.
    Torch ranks are separate programs, so ``k_local`` is the rank's own
    count (the JAX ``plan_overlap`` needed one ``k`` common to every
    device)."""
    if hasattr(B, "Pi"):
        raise ValueError("the overlap order is planned for 1-D packs")
    S = np.asarray(B.Phi.spl).size - 1
    if ranges is None:
        ranges = split_ranges(stored_per_stripe(B), halo.ndev)
    s0, s1 = _checked(ranges, S, halo.ndev, rank)
    lo = rank * halo.tiles_per_dev * TILE
    hi = lo + halo.tiles_per_dev * TILE
    pos = np.asarray(B.pos, dtype=np.int64)[s0:s1 + 1]
    rows, _ = _row_spans(B, s0, s1)
    outside = np.concatenate([[0], np.cumsum((rows < lo) | (rows >= hi))])
    local = outside[pos[1:] - pos[0]] == outside[pos[:-1] - pos[0]]
    order = np.concatenate([np.flatnonzero(local), np.flatnonzero(~local)])
    return order, int(local.sum())


def stripe_columns(B, order) -> np.ndarray:
    """The columns of stripes ``order`` of a pack, stripe by stripe."""
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    order = np.asarray(order, dtype=np.int64)
    w = spl[order + 1] - spl[order]
    return np.repeat(spl[order], w) + _ramps(w)


def permute_stripes(B: VBC1D, order) -> VBC1D:
    """The 1-D pack of the columns of ``B``'s stripes ``order``, in that
    order (each stripe whole, its blocks and values as they were)."""
    order = np.asarray(order, dtype=np.int64)
    spl = np.asarray(B.Phi.spl, dtype=np.int64)
    pos = np.asarray(B.pos, dtype=np.int64)
    ofs = np.asarray(B.ofs, dtype=np.int64)
    nb = pos[order + 1] - pos[order]
    nv = ofs[order + 1] - ofs[order]
    spl_new = np.concatenate([[0], np.cumsum(spl[order + 1] - spl[order])])

    def cut(starts, lengths):
        return np.repeat(starts, lengths) + _ramps(lengths)

    return VBC1D(
        m=int(B.m), n=int(spl_new[-1]), W=int(B.W), Phi=SplitPartition(spl_new),
        pos=np.concatenate([[0], np.cumsum(nb)]).astype(np.asarray(B.pos).dtype),
        idx=np.asarray(B.idx)[cut(pos[order], nb)],
        ofs=np.concatenate([[0], np.cumsum(nv)]).astype(np.asarray(B.ofs).dtype),
        val=np.asarray(B.val)[cut(ofs[order], nv)])
