"""Stripe-sharded TrSpMV, 1-D and 2-D: replicated x, tile halo and
overlapped halo.

Counterpart of ``vbcs_tpu/parallel/pallas_spmv.py``, ``pallas_spmv2d.py``
and ``pallas_spmv3.py``: ``shard_stream``/``place``, ``shard_stream_2d``/
``place_2d`` and ``shard_oneshot3``/``place3`` (one rank's part:
:func:`shard_stream`, the last with ``balance="even"``),
``dist_tr_spmv_pallas``, ``dist_tr_spmv_pallas_2d`` and
``dist_tr_spmv_oneshot3`` (:func:`dist_tr_spmv_replicated`),
``dist_tr_spmv_pallas_halo`` and ``dist_tr_spmv_pallas_2d_halo``
(:func:`dist_tr_spmv_halo`), ``plan_overlap`` (``shard.plan_overlap``)
and ``dist_tr_spmv_pallas_halo_overlap`` (:func:`dist_tr_spmv_halo_overlap`).
The JAX paths cut the v2 chunk streams (or the v3 slot layouts) across a
mesh and run their Pallas class kernels in ``shard_map``; here each rank
of a ``torch.distributed`` world holds a contiguous range of the pack's
stripes (balanced by stored values, ``shard.split_ranges``, or by stripe
count, ``shard.even_ranges``) on its own device and runs the port's
stripe kernel (``ops/trspmv.py``) or, on a 2-D pack, its tile kernel
(``ops/trspmv2d.py``).  Each rank's ``y`` is a disjoint column slice:
one padded all-gather and a cut put them in column order.

``x`` arrives sharded: each rank passes its own ``tiles_per_dev`` aligned
tiles (:func:`own_x`).  The replicated path all-gathers them; the halo
paths move only the tiles each rank reads, with one ``all_to_all_single``
(``shard.HaloPlan``), into the rank's *stage* (its own tiles, then the
received ones by source).  The tiles a rank sends are one tile copy
(``ops/gather.gather_tiles``) of its own tiles on the plan's send list.
The stripe kernel reads x by block row, so a 1-D shard's block rows are
rewritten into stage coordinates on the host (``HaloPlan.to_stage``) and
the kernel reads the stage as it lies.  The tile kernel reads ``u``
consecutive x rows from a tile's first row, and a tile whose rows
straddle two x tiles finds them apart in the stage, so the 2-D path
copies the stage's tiles into a pool in global tile order (a second tile
copy) and runs on tile rows in pool coordinates.  The stripe kernel
needs no v1 fallback class: a shard whose rows span everything has every
tile for its halo, which is replication; and the tile kernel takes tiles
of any height, so a mixed-height pack shards as any other (the JAX 2-D
version raises ``NotImplementedError`` there).

The overlapped path orders the rank's stripes with the local ones first
(rows only in its own tiles, ``shard.plan_overlap``), launches them on
its own tiles while the exchange is in flight, then the rest on the
stage.  Each of its two formats carries a ``col_out`` that puts its
columns at their natural place in the rank's slice, so both launches
write one buffer (``tr_spmv``'s ``out``) in column order and ``y`` is
assembled as on the halo path, with no gather (the JAX path's
``windowed_gather`` exit permute).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..formats.device import VBC1DDevice, VBC2DDevice
from ..ops.gather import gather_tiles
from ..ops.trspmv import tr_spmv
from ..ops.trspmv2d import tr_spmv_2d
from . import comm
from .shard import (TILE, HaloPlan, even_ranges, permute_stripes,
                    plan_halo, plan_overlap, shard_1d, shard_2d, split_ranges,
                    stored_per_stripe, stripe_columns)

__all__ = ["StreamShard", "shard_stream", "own_x", "dist_tr_spmv_replicated",
           "dist_tr_spmv_halo", "dist_tr_spmv_halo_overlap"]


@dataclasses.dataclass(eq=False)
class StreamShard:
    """One rank's part of a stripe-sharded 1-D or 2-D pack: the stripe
    ranges every rank shares and, built on first use, its column slice
    ``host`` (rows global), the halo plan and, on ``device``, the formats
    and index maps each path reads (``spmv.py`` adds the operator's
    route)."""

    rank: int
    ndev: int
    pack: object  # the whole host pack (VBC1D or VBC2D)
    ranges: list  # stripe range of each rank
    device: torch.device
    group: object = None

    @functools.cached_property
    def halo(self) -> HaloPlan:
        """The halo plan every rank computes alike (``shard.plan_halo``)."""
        return plan_halo(self.pack, self.ndev, self.ranges)

    @property
    def is_2d(self) -> bool:
        return hasattr(self.pack, "Pi")

    @property
    def m(self) -> int:
        return int(self.pack.m)

    @property
    def n(self) -> int:
        return int(self.pack.n)

    @functools.cached_property
    def host(self):
        """This rank's column slice of the pack (``shard.shard_1d``/``shard_2d``)."""
        cut = shard_2d if self.is_2d else shard_1d
        return cut(self.pack, self.ndev, self.rank, self.ranges)

    @functools.cached_property
    def col_starts(self) -> np.ndarray:
        """First column of each rank's slice, then ``n``."""
        spl = np.asarray(self.pack.Phi.spl, dtype=np.int64)
        return spl[[a for a, _ in self.ranges] + [self.ranges[-1][1]]]

    @property
    def widths(self) -> list[int]:
        """Columns of each rank's slice, in rank order."""
        return [int(w) for w in np.diff(self.col_starts)]

    @property
    def kernel(self):
        return tr_spmv_2d if self.is_2d else tr_spmv

    def _device_format(self, host):
        cls = VBC2DDevice if self.is_2d else VBC1DDevice
        return cls.from_host(host, self.device)

    def _map(self, a) -> torch.Tensor:
        """An int32 map (tiles or columns) on the device."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

    @functools.cached_property
    def fmt(self):
        """The slice on the device, rows global (the replicated path)."""
        return self._device_format(self.host)

    @functools.cached_property
    def send_tiles(self) -> torch.Tensor:
        """The rank's own x tiles it sends, its own tile ids: ``hmax`` for
        each destination in turn (padding: tile 0); the tile copy's map."""
        return self._map(self.halo.send[self.rank].reshape(-1))

    @functools.cached_property
    def pool_tiles(self) -> torch.Tensor:
        """Where each tile of the rank's pool sits in its stage (own tiles,
        then the received ones: ``_exchange``); the 2-D path's tile copy's
        map."""
        return self._map(self.halo.pool_src(self.rank))

    @functools.cached_property
    def halo_fmt(self):
        """The slice on the device as the halo path's kernel reads it: 1-D
        block rows in stage coordinates, 2-D tile rows in pool coordinates."""
        if not self.is_2d:
            return self._device_format(self._staged(self.host))
        rspl = np.asarray(self.pack.Pi.spl, dtype=np.int64)
        k = np.asarray(self.host.idx, dtype=np.int64)
        row, tall = rspl[k], rspl[k + 1] > rspl[k]
        pooled = np.zeros_like(row)  # a height-0 tile reads no x
        pooled[tall] = self.halo.to_pool(self.rank, row[tall])
        return dataclasses.replace(
            self.fmt, m=self.pool_rows,
            tile_row=torch.from_numpy(pooled.astype(np.int32)).to(self.device))

    @property
    def pool_rows(self) -> int:
        return int(self.halo.needed[self.rank].size) * TILE

    def _staged(self, host):
        """A 1-D ``host`` with its block rows at their place in the stage."""
        return dataclasses.replace(host, m=self.halo.stage_rows,
                                   idx=self.halo.to_stage(self.rank, host.idx))

    @functools.cached_property
    def overlap(self) -> tuple[np.ndarray, int]:
        """This rank's stripe order, local stripes first, and their count."""
        return plan_overlap(self.pack, self.halo, self.rank, self.ranges)

    @functools.cached_property
    def overlap_fmts(self):
        """(local stripes, rows in own-tile coordinates; the rest, rows in
        stage coordinates) on the device, each with a ``col_out`` that puts
        its columns at their place in the rank's slice."""
        order, k = self.overlap
        lo, _ = self.halo.own_rows(self.rank)
        local = permute_stripes(self.host, order[:k])
        local = dataclasses.replace(
            local, m=self.halo.tiles_per_dev * TILE,
            idx=np.asarray(local.idx, dtype=np.int64) - lo)
        rest = self._staged(permute_stripes(self.host, order[k:]))
        places = [stripe_columns(self.host, order[:k]),
                  stripe_columns(self.host, order[k:])]
        if not np.array_equal(np.sort(np.concatenate(places)),
                              np.arange(self.host.n)):
            raise ValueError("the overlap order does not place every column once")
        return tuple(dataclasses.replace(self._device_format(h), col_out=self._map(c))
                     for h, c in zip((local, rest), places))


def shard_stream(B, *, device, group=None, balance: str = "stored") -> StreamShard:
    """This rank's :class:`StreamShard` of a host pack (1-D or 2-D, this
    port's or the JAX package's).  ``balance`` cuts the stripes into
    contiguous ranges of near-equal stored values (``"stored"``,
    ``shard.split_ranges``) or near-equal stripe counts (``"even"``,
    ``shard.even_ranges``: the column-stripe path); ranges and halo plan
    are computed on the host alike on every rank of ``group`` (default:
    the world) when a path first needs them."""
    if balance not in ("stored", "even"):
        raise ValueError(f"balance must be 'stored' or 'even', got {balance!r}")
    ndev, rank = comm.world(group)
    if balance == "stored":
        ranges = split_ranges(stored_per_stripe(B), ndev)
    else:
        ranges = even_ranges(np.asarray(B.Phi.spl).size - 1, ndev)
    return StreamShard(rank=rank, ndev=ndev, pack=B, ranges=ranges,
                       device=torch.device(device), group=group)


def own_x(sh: StreamShard, x: torch.Tensor) -> torch.Tensor:
    """This rank's own tiles of a whole ``x`` (``[m]``): ``tiles_per_dev *
    TILE`` rows, zero past ``m``; what the paths take as ``x_own``."""
    lo, hi = sh.halo.own_rows(sh.rank)
    out = x.new_zeros(sh.halo.tiles_per_dev * TILE)
    out[:hi - lo] = x[lo:hi]
    return out


def _exchange(sh: StreamShard, x_own, async_op=False):
    """Start the halo exchange into the rank's stage (its own tiles, then
    ``ndev * hmax`` received ones by source), the tiles sent one tile
    copy: ``(stage, work handle or None)``."""
    own = x_own.numel()
    stage = x_own.new_empty(sh.halo.stage_rows)
    stage[:own] = x_own
    work = comm.all_to_all(stage[own:], gather_tiles(x_own, sh.send_tiles),
                           sh.group, async_op=async_op)
    return stage, work


def dist_tr_spmv_replicated(sh: StreamShard, x_own: torch.Tensor,
                            alpha=None) -> torch.Tensor:
    """``y = alpha * A.T @ x`` (``[n]`` on every rank; ``alpha=None`` is 1):
    ``x`` all-gathered from the ranks' own tiles, the stripe or tile
    kernel on this rank's slice."""
    x = comm.all_gather_x(x_own, sh.m, sh.group)
    return comm.gather_y(sh.kernel(sh.fmt, x, alpha), sh.widths, sh.group)


def _halo_x(sh: StreamShard, stage: torch.Tensor) -> torch.Tensor:
    """The x the halo path's kernel reads: the stage (1-D), or its tiles
    copied into the pool (2-D)."""
    return gather_tiles(stage, sh.pool_tiles) if sh.is_2d else stage


def dist_tr_spmv_halo(sh: StreamShard, x_own: torch.Tensor) -> torch.Tensor:
    """``y = A.T @ x`` with one ``all_to_all_single`` of the halo tiles, the
    stripe kernel on the rank's stage or the tile kernel on its pool."""
    stage, _ = _exchange(sh, x_own)
    y = sh.kernel(sh.halo_fmt, _halo_x(sh, stage))
    return comm.gather_y(y, sh.widths, sh.group)


def dist_tr_spmv_halo_overlap(sh: StreamShard, x_own: torch.Tensor) -> torch.Tensor:
    """:func:`dist_tr_spmv_halo` with the exchange in flight while the
    stripe kernel runs the rank's local stripes on its own tiles; the rest
    run on the stage once it has arrived, into the same buffer (1-D
    packs)."""
    local, rest = sh.overlap_fmts
    stage, work = _exchange(sh, x_own, async_op=True)
    y = x_own.new_empty(sh.host.n)
    tr_spmv(local, x_own, out=y)
    work.wait()
    tr_spmv(rest, stage, out=y)
    return comm.gather_y(y, sh.widths, sh.group)
