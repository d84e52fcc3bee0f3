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
(``shard.HaloPlan``), into a pool in global tile order on which the
kernel runs with its block rows (tile rows) rewritten into pool
coordinates.  The tile kernel reads ``u`` consecutive x rows from a
tile's first row, so a tile whose rows straddle two x tiles owned by two
ranks reads them next to each other in the pool.  The stripe kernel
reads x by block row, so a shard whose rows span everything needs no v1
fallback class: its halo is every tile, which is replication; and the
tile kernel takes tiles of any height, so a mixed-height pack shards as
any other (the JAX 2-D version raises ``NotImplementedError`` there).

The three permutations of the halo paths (the tiles a rank sends, its
pool, and on the overlapped path ``y`` out of each rank's overlap order)
run the gather kernel (``ops/gather.py``, the port of the windowed
gather that puts ``y`` in order on the JAX paths), each through an int32
element map built once per shard.

The overlapped path orders the rank's stripes with the local ones first
(rows only in its own tiles, ``shard.plan_overlap``), launches them on
its own tiles while the exchange is in flight, then the rest on the
pool.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..formats.device import VBC1DDevice, VBC2DDevice
from ..ops.gather import gather
from ..ops.trspmv import tr_spmv
from ..ops.trspmv2d import tr_spmv_2d
from . import comm
from .shard import (TILE, HaloPlan, even_ranges, permute_stripes,
                    plan_halo, plan_overlap, shard_1d, shard_2d, split_ranges,
                    stored_per_stripe, stripe_columns)

__all__ = ["StreamShard", "shard_stream", "own_x", "dist_tr_spmv_replicated",
           "dist_tr_spmv_halo", "dist_tr_spmv_halo_overlap"]


def _tile_elements(tiles) -> np.ndarray:
    """The element ids of whole 1,024-row tiles ``tiles``, tile by tile."""
    tiles = np.asarray(tiles, dtype=np.int64)
    return (tiles[:, None] * TILE + np.arange(TILE)[None, :]).reshape(-1)


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
    def width(self) -> int:
        """The widest slice: each rank's y is padded to it for the gather."""
        return max(1, *self.widths)

    @property
    def kernel(self):
        return tr_spmv_2d if self.is_2d else tr_spmv

    def _device_format(self, host):
        cls = VBC2DDevice if self.is_2d else VBC1DDevice
        return cls.from_host(host, self.device)

    def _map(self, a) -> torch.Tensor:
        """An int32 map for the gather kernel, on the device."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

    @functools.cached_property
    def fmt(self):
        """The slice on the device, rows global (the replicated path)."""
        return self._device_format(self.host)

    @functools.cached_property
    def send_map(self) -> torch.Tensor:
        """Elements of the rank's own x tiles it sends: ``hmax`` tiles for
        each destination in turn."""
        return self._map(_tile_elements(self.halo.send[self.rank].reshape(-1)))

    @functools.cached_property
    def pool_map(self) -> torch.Tensor:
        """Where each element of the rank's pool sits in its stage (own
        tiles, then the received ones: ``_exchange``)."""
        return self._map(_tile_elements(self.halo.pool_src(self.rank)))

    @functools.cached_property
    def pool_fmt(self):
        """The slice on the device, rows in pool coordinates (the halo path)."""
        if not self.is_2d:
            return self._device_format(self._pooled(self.host))
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

    def _pooled(self, host):
        return dataclasses.replace(host, m=self.pool_rows,
                                   idx=self.halo.to_pool(self.rank, host.idx))

    @functools.cached_property
    def overlap(self) -> tuple[np.ndarray, int]:
        """This rank's stripe order, local stripes first, and their count."""
        return plan_overlap(self.pack, self.halo, self.rank, self.ranges)

    @functools.cached_property
    def overlap_fmts(self):
        """(local stripes, rows in own-tile coordinates; the rest, rows in
        pool coordinates) on the device."""
        order, k = self.overlap
        lo, _ = self.halo.own_rows(self.rank)
        local = permute_stripes(self.host, order[:k])
        local = dataclasses.replace(
            local, m=self.halo.tiles_per_dev * TILE,
            idx=np.asarray(local.idx, dtype=np.int64) - lo)
        rest = self._pooled(permute_stripes(self.host, order[k:]))
        return self._device_format(local), self._device_format(rest)

    @functools.cached_property
    def y_map_overlap(self) -> torch.Tensor:
        """Element of the gathered ``[ndev * width]`` stack holding
        each output column, the slices holding their columns in each
        rank's overlap order."""
        width = self.width
        out = np.empty(self.n, dtype=np.int64)
        for d, (s0, _) in enumerate(self.ranges):
            order, _ = plan_overlap(self.pack, self.halo, d, self.ranges)
            cols = stripe_columns(self.pack, order + s0)
            out[cols] = d * width + np.arange(cols.size)
        return self._map(out)


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
    ``ndev * hmax`` received ones by source): ``(stage, work handle or
    None)``."""
    own = x_own.numel()
    stage = x_own.new_empty(own + sh.send_map.numel())
    stage[:own] = x_own
    work = comm.all_to_all(stage[own:], gather(x_own, sh.send_map), sh.group,
                           async_op=async_op)
    return stage, work


def dist_tr_spmv_replicated(sh: StreamShard, x_own: torch.Tensor,
                            alpha=None) -> torch.Tensor:
    """``y = alpha * A.T @ x`` (``[n]`` on every rank; ``alpha=None`` is 1):
    ``x`` all-gathered from the ranks' own tiles, the stripe or tile
    kernel on this rank's slice."""
    x = comm.all_gather_x(x_own, sh.m, sh.group)
    return comm.gather_y(sh.kernel(sh.fmt, x, alpha), sh.widths, sh.group)


def dist_tr_spmv_halo(sh: StreamShard, x_own: torch.Tensor) -> torch.Tensor:
    """``y = A.T @ x`` with one ``all_to_all_single`` of the halo tiles, the
    stripe or tile kernel on the rank's pool."""
    stage, _ = _exchange(sh, x_own)
    y = sh.kernel(sh.pool_fmt, gather(stage, sh.pool_map))
    return comm.gather_y(y, sh.widths, sh.group)


def dist_tr_spmv_halo_overlap(sh: StreamShard, x_own: torch.Tensor) -> torch.Tensor:
    """:func:`dist_tr_spmv_halo` with the exchange in flight while the
    stripe kernel runs the rank's local stripes on its own tiles; the rest
    run on the pool once it has arrived (1-D packs)."""
    local, rest = sh.overlap_fmts
    stage, work = _exchange(sh, x_own, async_op=True)
    y_local = tr_spmv(local, x_own)
    work.wait()
    y_rest = tr_spmv(rest, gather(stage, sh.pool_map))
    stack = comm.gather_stack(torch.cat([y_local, y_rest]), sh.width, sh.group)
    return gather(stack, sh.y_map_overlap)
