"""The VBC arrays on a torch device — what the kernels read.

Port of the device-format role of ``vbcs_tpu/formats/device.py``
(``VBC1DDevice``, ``bin_vbc2d``), of ``StreamFormat3`` in
``vbcs_tpu/ops/pallas_trspmv3.py`` and of ``Stream2DBundle`` in
``vbcs_tpu/ops/pallas_trspmv2d.py``.  Those binned, padded and re-tiled
the matrix for Mosaic (width and (u, w) classes, A-tables, window ids,
slot space).  The GPU kernels read the host VBC1D/VBC2D arrays as they
are, so these formats are only their int32/f32 copies on an explicit
device, plus ``col_stripe[j]``, the stripe that owns output column ``j``,
and for the 2-D format each tile's first row and value offset
(``tile_row``, ``tile_ofs``), built once on the device so that the tile
kernel reads a tile's place without the ``idx -> Pi.spl`` chain.
``ScatterDevice`` is the port of ``ScatterFormat`` in
``vbcs_tpu/ops/pallas_scatter.py``: the same per-column entry lists, as
a CSC on the device instead of an (8, Np) slot buffer with a router,
cut into tiles of whole columns for its kernel (:class:`ScatterTiles`).

A pack of the relabeled ``A[perm][:, perm]`` (auto-RCM) has a *natural
view* (``natural_view(perm)``): its block rows are ``perm[idx]`` and
``col_out[j] = perm[j]`` says where output column ``j`` goes, so the
kernels read natural x and write natural y with no gather around them.

A pack of A whose forward products run the ordered scatter
(``ops/ordered.py``) carries its :class:`OrderedMaps`
(``VBC1DDevice.ordered_maps``): where each block's row of products goes,
and which slots each row of Y sums; and, for an X narrower than a
32-byte sector, its :class:`RowBlocks` (``VBC1DDevice.row_blocks``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["VBC1DDevice", "VBC2DDevice", "ScatterDevice", "ScatterTiles",
           "SemiringDevice", "OrderedMaps", "ordered_maps", "RowBlocks", "row_blocks",
           "SCATTER_LANE_ENTRIES",
           "SCATTER_TILE", "SPMM_LONG_BLOCKS", "WIDTH_CLASSES", "width_class"]

_I32_MAX = np.iinfo(np.int32).max

# the scatter kernel's entry tiles (csrc/scatter.cu: E and TILE): each
# of a warp's 32 lanes takes SCATTER_LANE_ENTRIES consecutive entries
SCATTER_LANE_ENTRIES = 4
SCATTER_TILE = 32 * SCATTER_LANE_ENTRIES


def _check_perm(perm: torch.Tensor, n: int, device) -> None:
    """A relabeling the natural views take: int32 ``[n]`` on ``device``.
    That it is a permutation is the caller's to check (``VBCOperator``
    checks ``row_perm`` on the host): the kernels write ``y[col_out[j]]``
    unchecked, and a repeated index would race."""
    if not isinstance(perm, torch.Tensor) or perm.dtype != torch.int32:
        raise TypeError("perm must be an int32 tensor")
    if perm.shape != (n,) or perm.device != device or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous [{n}] tensor on {device}")


def _tensor_bytes(*arrays) -> int:
    return sum(t.numel() * t.element_size() for t in arrays if t is not None)


def _i32(a, name: str, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and (int(a.max()) > _I32_MAX or int(a.min()) < 0):
        raise ValueError(f"{name} does not fit in int32")
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _vbc1d_arrays(host):
    """``(m, n, spl, pos, idx, ofs, val)`` of a host 1D-VBC, the index
    arrays as int64; raises ``ValueError`` on an inconsistent pack, a
    block row out of range or dimensions beyond int32."""
    spl = np.asarray(host.Phi.spl, dtype=np.int64)
    pos = np.asarray(host.pos, dtype=np.int64)
    idx = np.asarray(host.idx, dtype=np.int64)
    ofs = np.asarray(host.ofs, dtype=np.int64)
    val = np.asarray(host.val)
    L = spl.size - 1
    m, n = int(host.m), int(host.n)
    widths = np.diff(spl)
    nblk = np.diff(pos)
    if not (pos.size == ofs.size == L + 1 and spl[0] == 0 and spl[-1] == n
            and pos[0] == 0 and pos[-1] == idx.size and ofs[0] == 0
            and ofs[-1] == val.size and np.all(widths >= 0)
            and np.all(nblk >= 0)
            and np.array_equal(np.diff(ofs), nblk * widths)):
        raise ValueError("inconsistent 1D-VBC pack")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= m):
        raise ValueError("block row index out of range")
    if max(m, n) > _I32_MAX:
        raise ValueError("matrix dimensions do not fit in int32")
    return m, n, spl, pos, idx, ofs, val


# the SpMM kernel's accumulator widths (csrc/spmm.cu: its width classes)
WIDTH_CLASSES = (1, 2, 4, 8)
# a stripe of more blocks is a long stripe, walked by a whole thread block
# of the SpMM kernel (VBC1DDevice.long_stripes)
SPMM_LONG_BLOCKS = 128


def width_class(widths, nblk) -> int:
    """The SpMM kernel's width class of a pack with stripe ``widths`` and
    block counts ``nblk`` (NumPy arrays): the narrowest of
    :data:`WIDTH_CLASSES` whose passes over the wider stripes (a stripe of
    width ``w`` is walked ``ceil(w / c)`` times, each pass reading its
    blocks' X rows) read at most 1/16 more blocks than one pass does."""
    widths = np.asarray(widths, dtype=np.int64)
    nblk = np.asarray(nblk, dtype=np.int64)
    total = int(nblk.sum())
    for c in WIDTH_CLASSES[:-1]:
        if 16 * int((((widths + c - 1) // c - 1).clip(0) * nblk).sum()) <= total:
            return c
    return WIDTH_CLASSES[-1]


def _blocks_1d(spl, pos, ofs, nvals: int):
    """(block, col) of every stored value of a 1D-VBC, int64, from its
    ``spl``/``pos``/``ofs`` as tensors on one device."""
    dev = spl.device
    L = spl.numel() - 1
    widths = (spl[1:] - spl[:-1]).long()
    nblk = (pos[1:] - pos[:-1]).long()
    stripe = torch.repeat_interleave(
        torch.arange(L, device=dev), nblk * widths, output_size=nvals)
    local = torch.arange(nvals, device=dev) - ofs[stripe].long()
    w = widths[stripe]
    blk = pos[stripe].long() + torch.div(local, w, rounding_mode="floor")
    col = spl[stripe].long() + local % w
    return blk, col


def _coords_1d(spl, pos, idx, ofs, nvals: int):
    """(row, col) of every stored value of a 1D-VBC, int64, from its
    ``spl``/``pos``/``idx``/``ofs`` as tensors on one device."""
    blk, col = _blocks_1d(spl, pos, ofs, nvals)
    return idx[blk].long(), col


class OrderedMaps(NamedTuple):
    """The ordered scatter's maps of a pack of A (``ops/ordered.py``,
    ``csrc/ordered.cu``): where each block's row of products goes, and
    how each row of ``Y = A @ X`` is made.  A *slot* is a row of the
    partial buffer; the slots of a row are consecutive, rows in ascending
    order, a row's slots in the order of its blocks (stripe order)."""

    dest: torch.Tensor  # [blocks] int32: the block's row of Y where it is
    #   its row's only block (>= 0), else -(slot + 1)
    row_ptr: torch.Tensor  # [m + 1] int32: row r's slots run from
    #   start(row_ptr[r]) to start(row_ptr[r + 1]), start(v) = v for v >= 0
    #   and -v - 1 below; row_ptr[r] < 0 marks a row of one block (no slot)
    slots: int  # rows of the partial buffer
    rows_pass: bool  # a row has no block or several: the rows launch has work

    @property
    def nbytes(self) -> int:
        """Bytes the maps hold on the device (read once a call)."""
        return _tensor_bytes(self.dest, self.row_ptr)


class RowBlocks(NamedTuple):
    """The blocks of each row of a pack of A, for the ordered scatter by
    block (``ops/ordered.py``, below k = 8): row r's blocks are
    ``blocks[start[r]:start[r + 1]]``, in block (stripe) order."""

    start: torch.Tensor  # [m + 1] int32
    blocks: torch.Tensor  # [blocks] int32

    @property
    def nbytes(self) -> int:
        return _tensor_bytes(self.start, self.blocks)


def row_blocks(idx: torch.Tensor, m: int) -> RowBlocks:
    """:class:`RowBlocks` of a pack whose blocks sit on rows ``idx`` (int32,
    in block order) of an ``m``-row matrix, with torch ops on its device."""
    rows = idx.long()
    start = torch.zeros(m + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum(torch.bincount(rows, minlength=m), 0, out=start[1:])
    return RowBlocks(start=start.int(), blocks=torch.argsort(rows, stable=True).int())


def ordered_maps(idx: torch.Tensor, m: int) -> OrderedMaps:
    """:class:`OrderedMaps` of a pack whose blocks sit on rows ``idx``
    (int32, in block order) of an ``m``-row matrix, computed with torch
    ops on ``idx``'s device."""
    dev = idx.device
    rows = idx.long()
    cnt = torch.bincount(rows, minlength=m)
    start = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.where(cnt >= 2, cnt, 0), 0, out=start[1:])
    first = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(cnt, 0, out=first[1:])
    order = torch.argsort(rows, stable=True)  # blocks by row, then block
    r = rows[order]
    slot = start[r] + torch.arange(rows.numel(), device=dev) - first[r]
    dest = torch.empty_like(rows)
    dest[order] = torch.where(cnt[r] >= 2, -slot - 1, r)
    row_ptr = start.clone()
    row_ptr[:m] = torch.where(cnt == 1, -start[:m] - 1, start[:m])
    slots = int(start[m])
    if slots > _I32_MAX:
        raise ValueError("the ordered scatter's slot count does not fit in int32")
    return OrderedMaps(dest=dest.int(), row_ptr=row_ptr.int(), slots=slots,
                       rows_pass=bool((cnt != 1).any()))


@dataclasses.dataclass(frozen=True)
class VBC1DDevice:
    m: int
    n: int
    W: int
    spl: torch.Tensor  # [L + 1] int32 stripe column splits
    pos: torch.Tensor  # [L + 1] int32 block pointers into idx
    idx: torch.Tensor  # [num_blocks] int32 block rows
    ofs: torch.Tensor  # [L + 1] int32 value offsets per stripe
    val: torch.Tensor  # [total_vals] f32 (or f64) block values
    col_stripe: torch.Tensor  # [n] int32 stripe of each column
    col_out: torch.Tensor | None = None  # [n] int32 output place (natural view)
    # every stripe width a multiple of 4: the stripe kernel then gives a
    # thread four columns, a float4 of values a block (csrc/trspmv.cu)
    quad_widths: bool = False
    # the SpMM kernel's accumulator width (csrc/spmm.cu; :func:`width_class`)
    width_class: int = 8
    # int32 ids of the stripes of more than SPMM_LONG_BLOCKS blocks, which
    # the SpMM kernel walks a thread block each; None: the kernel takes
    # every stripe by its lanes
    long_stripes: torch.Tensor | None = None
    # the stripe kernel's runs of stripes (filled on first use by
    # ``ops.trspmv.stage_plan``); ``natural_view`` and every other
    # ``dataclasses.replace`` hand the same dict on, as they hand on
    # ``spl``, ``pos`` and ``ofs``, and the entry names the arrays it was
    # cut from
    stage_plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def L(self) -> int:
        return int(self.spl.numel() - 1)

    @property
    def nbytes(self) -> int:
        """Bytes of the format arrays (each read at most once per call)."""
        return _tensor_bytes(self.spl, self.pos, self.idx, self.ofs, self.val,
                             self.col_stripe, self.col_out, self.long_stripes)

    def natural_view(self, perm: torch.Tensor) -> "VBC1DDevice":
        """The natural view of this pack of ``A[perm][:, perm]``: block rows
        ``perm[idx]`` (computed once, on the device) and ``col_out = perm``,
        so ``tr_spmv``/``tr_spmm`` read natural x and write natural y.  It
        shares ``spl``, ``pos``, ``ofs``, ``val``, ``col_stripe`` and the
        stripe kernel's runs (``stage_plans``) with this pack; ``idx`` and
        ``col_out`` are its own."""
        _check_perm(perm, self.n, self.device)
        if self.m != self.n or self.col_out is not None:
            raise ValueError("a natural view needs a square pack in relabeled order")
        return dataclasses.replace(self, idx=perm[self.idx.long()], col_out=perm)

    @staticmethod
    def from_host(host, device, dtype=torch.float32) -> "VBC1DDevice":
        """Copy a host 1D-VBC to ``device``, its values as ``dtype``:
        float32 (the default, whatever the pack's own dtype) or float64,
        the stripe kernel's two value types (an f64 pack keeps its
        values; ``VBCOperator`` copies an f64 matrix so).

        ``host`` is any object with ``m, n, W, Phi.spl, pos, idx, ofs,
        val`` as NumPy arrays: this port's ``VBC1D`` or the JAX
        package's, so both packages can run the same pack.  Raises
        ``ValueError`` on an inconsistent pack, on an index that does not
        fit in int32 (the kernel does no bounds checks of its own) or on
        another ``dtype``."""
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"the stripe kernel's values are float32 or float64, "
                             f"not {dtype}")
        m, n, spl, pos, idx, ofs, val = _vbc1d_arrays(host)
        L = spl.size - 1
        col_stripe = np.repeat(np.arange(L, dtype=np.int64), np.diff(spl))
        return VBC1DDevice(
            m=m,
            n=n,
            W=int(host.W),
            spl=_i32(spl, "spl", device),
            pos=_i32(pos, "pos", device),
            idx=_i32(idx, "idx", device),
            ofs=_i32(ofs, "ofs", device),
            val=torch.from_numpy(np.ascontiguousarray(
                val, dtype=np.float32 if dtype == torch.float32 else np.float64)).to(device),
            col_stripe=_i32(col_stripe, "col_stripe", device),
            quad_widths=bool(np.all(np.diff(spl) % 4 == 0)),
            width_class=width_class(np.diff(spl), np.diff(pos)),
            long_stripes=_i32(np.flatnonzero(np.diff(pos) > SPMM_LONG_BLOCKS),
                              "long_stripes", device),
        )

    @functools.cached_property
    def value_coords(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, col) of every stored value, int64 — the index form the
        plain PyTorch TrSpMV uses (computed once per format); natural
        coordinates on a natural view."""
        row, col = _coords_1d(self.spl, self.pos, self.idx, self.ofs,
                              self.val.numel())
        if self.col_out is not None:
            col = self.col_out.long()[col]
        return row, col

    @functools.cached_property
    def value_blocks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(block, col) of every stored value, int64 (computed once per
        format); natural columns on a natural view."""
        blk, col = _blocks_1d(self.spl, self.pos, self.ofs, self.val.numel())
        if self.col_out is not None:
            col = self.col_out.long()[col]
        return blk, col

    @functools.cached_property
    def ordered_maps(self) -> OrderedMaps:
        """The ordered scatter's maps of this pack of A (built once, on
        its device): its blocks' rows ``idx``, natural on a natural
        view, so the scatter writes natural order."""
        return ordered_maps(self.idx, self.m)

    @functools.cached_property
    def row_blocks(self) -> RowBlocks:
        """The ordered scatter's row -> blocks map of this pack of A, for an
        X narrower than a sector (built on first use, on its device)."""
        return row_blocks(self.idx, self.m)

    def ordered_bytes(self) -> int:
        """Bytes the ordered scatter's maps of this pack hold on the device:
        :attr:`ordered_maps`, and :attr:`row_blocks` once built."""
        built = self.__dict__.get("row_blocks")
        return self.ordered_maps.nbytes + (0 if built is None else built.nbytes)

    @functools.cached_property
    def chain_plans(self) -> dict:
        """The chain kernel's partitions of this pack, by (blocks, budget)
        (filled by ``ops.chain.chain_plan``)."""
        return {}


def _vbc2d_arrays(host):
    """``(m, n, rspl, spl, pos, idx, ofs, val)`` of a host 2-D VBC, the
    index arrays as int64; raises ``ValueError`` on an inconsistent pack
    (``diff(ofs)`` must be each stripe's sum of ``u_k * w_l`` over its
    tiles), a row block out of range or dimensions beyond int32."""
    rspl = np.asarray(host.Pi.spl, dtype=np.int64)
    spl = np.asarray(host.Phi.spl, dtype=np.int64)
    pos = np.asarray(host.pos, dtype=np.int64)
    idx = np.asarray(host.idx, dtype=np.int64)
    ofs = np.asarray(host.ofs, dtype=np.int64)
    val = np.asarray(host.val)
    K, L = rspl.size - 1, spl.size - 1
    m, n = int(host.m), int(host.n)
    heights, widths, ntile = np.diff(rspl), np.diff(spl), np.diff(pos)
    if not (pos.size == ofs.size == L + 1 and spl[0] == 0 and spl[-1] == n
            and rspl[0] == 0 and rspl[-1] == m and pos[0] == 0
            and pos[-1] == idx.size and ofs[0] == 0
            and ofs[-1] == val.size and np.all(widths >= 0)
            and np.all(heights >= 0) and np.all(ntile >= 0)):
        raise ValueError("inconsistent 2-D VBC pack")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= K):
        raise ValueError("row-block index out of range")
    tile_vals = heights[idx] * np.repeat(widths, ntile)
    cum = np.concatenate([[0], np.cumsum(tile_vals)])
    if not np.array_equal(np.diff(ofs), cum[pos[1:]] - cum[pos[:-1]]):
        raise ValueError("inconsistent 2-D VBC pack: stripe value counts "
                         "are not the sums of their tiles' u * w")
    if max(m, n) > _I32_MAX:
        raise ValueError("matrix dimensions do not fit in int32")
    return m, n, rspl, spl, pos, idx, ofs, val


def _tile_places(rspl, spl, pos, idx):
    """``(tile_row, tile_ofs)`` of a 2-D VBC's tiles, int64, from its
    ``rspl``/``spl``/``pos``/``idx`` as tensors on one device: each tile's
    first row and its value offset (``tile_ofs`` has one more entry, the
    value count)."""
    k = idx.long()
    w_tile = torch.repeat_interleave(
        (spl[1:] - spl[:-1]).long(), (pos[1:] - pos[:-1]).long(),
        output_size=idx.numel())
    tile_ofs = torch.zeros(idx.numel() + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum((rspl[k + 1] - rspl[k]).long() * w_tile, 0, out=tile_ofs[1:])
    return rspl[k].long(), tile_ofs


def _coords_2d(spl, pos, tile_row, tile_ofs, nvals: int):
    """(row, col) of every stored value of a 2-D VBC, int64, from its
    ``spl``/``pos`` and :func:`_tile_places` as tensors on one device."""
    dev = spl.device
    stripe = torch.repeat_interleave(
        torch.arange(spl.numel() - 1, device=dev), (pos[1:] - pos[:-1]).long(),
        output_size=tile_row.numel())
    start = tile_ofs.long()
    tile = torch.repeat_interleave(
        torch.arange(tile_row.numel(), device=dev), start[1:] - start[:-1],
        output_size=nvals)
    local = torch.arange(nvals, device=dev) - start[tile]
    wt = (spl[1:] - spl[:-1]).long()[stripe][tile]
    row = tile_row.long()[tile] + torch.div(local, wt, rounding_mode="floor")
    col = spl[stripe].long()[tile] + local % wt
    return row, col


@dataclasses.dataclass(frozen=True)
class VBC2DDevice:
    m: int
    n: int
    U: int
    W: int
    rspl: torch.Tensor  # [K + 1] int32 row-block splits (Pi.spl)
    spl: torch.Tensor  # [L + 1] int32 stripe column splits (Phi.spl)
    pos: torch.Tensor  # [L + 1] int32 tile pointers into idx
    idx: torch.Tensor  # [num_tiles] int32 row-block id of each tile
    ofs: torch.Tensor  # [L + 1] int32 value offsets per stripe
    val: torch.Tensor  # [total_vals] f32 tile values, row-major u x w
    col_stripe: torch.Tensor  # [n] int32 stripe of each column
    tile_row: torch.Tensor  # [num_tiles] int32 first row of each tile
    tile_ofs: torch.Tensor  # [num_tiles + 1] int32 value offset of each tile

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def K(self) -> int:
        return int(self.rspl.numel() - 1)

    @property
    def L(self) -> int:
        return int(self.spl.numel() - 1)

    @property
    def nbytes(self) -> int:
        """Bytes of the format arrays (each read at most once per call)."""
        return sum(t.numel() * t.element_size() for t in (
            self.rspl, self.spl, self.pos, self.idx, self.ofs, self.val,
            self.col_stripe, self.tile_row, self.tile_ofs))

    @staticmethod
    def from_host(host, device) -> "VBC2DDevice":
        """Copy a host 2-D VBC to ``device``, its values as f32.

        ``host`` is any object with ``m, n, U, W, Pi.spl, Phi.spl, pos,
        idx, ofs, val`` as NumPy arrays: this port's ``VBC2D`` or the JAX
        package's, so both packages can run the same pack.  Raises
        ``ValueError`` on an inconsistent pack (``diff(ofs)`` must be each
        stripe's sum of ``u_k * w_l`` over its tiles) or on an index that
        does not fit in int32 (the kernel does no bounds checks of its
        own)."""
        m, n, rspl, spl, pos, idx, ofs, val = _vbc2d_arrays(host)
        d_rspl = _i32(rspl, "Pi.spl", device)
        d_spl = _i32(spl, "Phi.spl", device)
        d_pos = _i32(pos, "pos", device)
        d_idx = _i32(idx, "idx", device)
        tile_row, tile_ofs = _tile_places(d_rspl, d_spl, d_pos, d_idx)
        return VBC2DDevice(
            m=m,
            n=n,
            U=int(host.U),
            W=int(host.W),
            rspl=d_rspl,
            spl=d_spl,
            pos=d_pos,
            idx=d_idx,
            ofs=_i32(ofs, "ofs", device),
            val=torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32)).to(device),
            col_stripe=_i32(np.repeat(np.arange(spl.size - 1), np.diff(spl)),
                            "col_stripe", device),
            tile_row=tile_row.int(),
            tile_ofs=tile_ofs.int(),  # ends at ofs[-1] = val.size: fits int32
        )

    def _tiles(self):
        """(stripe, height) of every tile, int64."""
        ntile = (self.pos[1:] - self.pos[:-1]).long()
        stripe = torch.repeat_interleave(
            torch.arange(self.L, device=self.device), ntile,
            output_size=self.idx.numel())
        heights = (self.rspl[1:] - self.rspl[:-1]).long()
        return stripe, heights[self.idx.long()]

    @functools.cached_property
    def value_coords(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, col) of every stored value, int64 — the index form the
        plain PyTorch TrSpMV uses (computed once per format)."""
        return _coords_2d(self.spl, self.pos, self.tile_row, self.tile_ofs,
                          self.val.numel())

    def view_1d(self) -> VBC1DDevice:
        """The 1-D view (``VBC2D.to_1d_view``) on the device: each u x w
        tile as u one-row blocks.  It shares ``val``, ``ofs``, ``spl`` and
        ``col_stripe`` with this format; only ``pos`` and ``idx`` are new,
        built once on first use (the view route of ``tr_mul`` and the
        SpMM share them)."""
        return self._view_1d

    @functools.cached_property
    def _view_1d(self) -> VBC1DDevice:
        dev = self.device
        stripe, u = self._tiles()
        rows = torch.zeros(self.L, dtype=torch.int64, device=dev)
        rows.index_add_(0, stripe, u)
        pos = torch.zeros(self.L + 1, dtype=torch.int64, device=dev)
        torch.cumsum(rows, 0, out=pos[1:])
        total = int(pos[-1])
        if total > _I32_MAX:
            raise ValueError("the 1-D view's block count does not fit in int32")
        tile = torch.repeat_interleave(
            torch.arange(self.idx.numel(), device=dev), u, output_size=total)
        idx = (self.tile_row.long()[tile]
               + torch.arange(total, device=dev) - (torch.cumsum(u, 0) - u)[tile])
        widths = (self.spl[1:] - self.spl[:-1]).cpu().numpy()
        return VBC1DDevice(
            m=self.m, n=self.n, W=self.W, spl=self.spl, pos=pos.int(),
            idx=idx.int(), ofs=self.ofs, val=self.val,
            col_stripe=self.col_stripe,
            quad_widths=bool(np.all(widths % 4 == 0)),
            width_class=width_class(widths, rows.cpu().numpy()),
            long_stripes=torch.nonzero(rows > SPMM_LONG_BLOCKS).flatten().int())


class ScatterTiles(NamedTuple):
    """The scatter kernel's work split (``csrc/scatter.cu``): the entries
    cut into tiles of whole columns, at most ``SCATTER_TILE`` entries each
    (a warp a tile, each lane ``SCATTER_LANE_ENTRIES`` consecutive
    entries); a column longer than a tile fills tiles of its own.
    Columns are counted by their ordinal ``q`` among the nonempty ones."""

    n_tiles: int
    tiles: torch.Tensor  # [n_tiles, 4] int32: first entry, q of the first
    #   entry, the first and last tile of the tile's column when it spans
    #   several (else the tile itself, twice)
    lanes: torch.Tensor  # [n_tiles * 32] int64, a lane's word: its first
    #   entry (bits 0-31), its first entry's q less the tile's (32-39), a
    #   bit for each of its entries that ends its column (40-47) and its
    #   entry count (48-51)
    out: torch.Tensor | None  # [nonempty] int32 output place of column q
    #   (None: q itself, a natural pack with no empty column)
    empty: torch.Tensor  # [empty] int32 output places of the empty columns
    scratch: torch.Tensor  # [2 * n_tiles] int32 zeros: arrival counts and
    #   the partial sums of the columns that span several tiles

    @property
    def nbytes(self) -> int:
        """Bytes the kernel reads besides the entries, x and y."""
        return _tensor_bytes(self.tiles, self.lanes, self.out, self.empty)


def _cut_tiles(bounds: np.ndarray) -> tuple[list, list, list]:
    """Greedy cut of a CSC's entries into tiles of whole columns of at
    most ``SCATTER_TILE`` entries; ``bounds`` are the nonempty columns'
    first entries, then the entry count.  A column longer than a tile
    gets tiles of its own (``SCATTER_TILE`` entries but the last).
    Returns each tile's first entry and the first and last tile of its
    column (the tile itself when it holds whole columns)."""
    TE = SCATTER_TILE
    reach = (np.searchsorted(bounds, bounds + TE, side="right") - 1).tolist()
    b = bounds.tolist()
    starts, lo, hi = [], [], []
    i = 0
    while i < len(b) - 1:
        t = len(starts)
        if reach[i] > i:  # whole columns up to the last that fits
            starts.append(b[i])
            lo.append(t)
            hi.append(t)
            i = reach[i]
        else:  # one long column, in tiles of its own
            chunk = list(range(b[i], b[i + 1], TE))
            starts += chunk
            lo += [t] * len(chunk)
            hi += [t + len(chunk) - 1] * len(chunk)
            i += 1
    return starts, lo, hi


@dataclasses.dataclass(frozen=True)
class ScatterDevice:
    """A 1D-VBC pack as a CSC on a torch device — each column's (row,
    value) entries, explicit fill kept — for the entry-tiled scatter
    kernel (``ops/scatter.py``)."""

    m: int
    n: int
    colptr: torch.Tensor  # [n + 1] int32 entry pointers per column
    row: torch.Tensor  # [nnz_stored] int32 row of each entry
    val: torch.Tensor  # [nnz_stored] f32 value of each entry
    col_out: torch.Tensor | None = None  # [n] int32 output place (natural view)

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def nbytes(self) -> int:
        """Bytes of the CSC arrays (the kernel reads :attr:`tiles` in
        place of ``colptr`` and ``col_out``)."""
        return _tensor_bytes(self.colptr, self.row, self.val, self.col_out)

    def natural_view(self, perm: torch.Tensor) -> "ScatterDevice":
        """The natural view of this pack of ``A[perm][:, perm]``: rows
        ``perm[row]`` (computed once, on the device) and ``col_out =
        perm``.  It shares ``colptr`` and ``val`` with this pack."""
        _check_perm(perm, self.n, self.device)
        if self.m != self.n or self.col_out is not None:
            raise ValueError("a natural view needs a square pack in relabeled order")
        return dataclasses.replace(self, row=perm[self.row.long()], col_out=perm)

    @functools.cached_property
    def tiles(self) -> ScatterTiles:
        """The kernel's entry tiles (:class:`ScatterTiles`), built once on
        first use: the cut on the host (one step a tile), the lane words
        with torch ops on the device."""
        dev = self.device
        E = SCATTER_LANE_ENTRIES
        colptr = self.colptr.long()
        cnt = colptr[1:] - colptr[:-1]
        nzcol = torch.nonzero(cnt > 0).flatten()
        empty = torch.nonzero(cnt == 0).flatten()
        nnz = self.row.numel()
        bounds = torch.cat([colptr[nzcol], colptr[-1:]]).cpu().numpy()
        starts, lo, hi = _cut_tiles(bounds)
        n_tiles = len(starts)
        start = torch.tensor(starts + [nnz], dtype=torch.int64, device=dev)
        # q of every entry, and whether it is its column's last
        key = torch.repeat_interleave(torch.arange(nzcol.numel(), device=dev),
                                      cnt[nzcol], output_size=nnz)
        ends = torch.ones(nnz, dtype=torch.int64, device=dev)
        ends[:-1] = (key[1:] != key[:-1]).long()
        first = start[:-1, None] + E * torch.arange(32, device=dev)  # [T, 32]
        pos = first[..., None] + torch.arange(E, device=dev)  # [T, 32, E]
        last = max(nnz - 1, 0)
        live = pos < start[1:, None, None]
        bits = torch.where(live, ends[pos.clamp(max=last)], 0)
        mask = (bits << torch.arange(E, device=dev)).sum(-1)
        q_tile = key[start[:-1].clamp(max=last)]
        dq = torch.where(first < start[1:, None],
                         key[first.clamp(max=last)] - q_tile[:, None], 0)
        word = (torch.where(first < start[1:, None], first, 0) | (dq << 32)
                | (mask << 40) | (live.sum(-1) << 48))
        place = self.col_out.long() if self.col_out is not None else None
        if place is None and empty.numel() == 0:
            out = None
        else:
            out = (nzcol if place is None else place[nzcol]).int()
        tiles = torch.stack([start[:-1], q_tile,
                             torch.tensor(lo, dtype=torch.int64, device=dev),
                             torch.tensor(hi, dtype=torch.int64, device=dev)], 1)
        return ScatterTiles(
            n_tiles=n_tiles, tiles=tiles.int().reshape(n_tiles, 4),
            lanes=word.reshape(-1), out=out,
            empty=(empty if place is None else place[empty]).int(),
            scratch=torch.zeros(2 * n_tiles, dtype=torch.int32, device=dev))

    @staticmethod
    def from_host(host, device) -> "ScatterDevice":
        """Flatten a host 1D-VBC (this port's or the JAX package's) into
        per-column entry lists (``ops.scatter.column_entries``), each
        column's entries in block order, and copy them to ``device``.
        Raises ``ValueError`` on an inconsistent pack or when an index or
        the entry count does not fit in int32."""
        from ..ops.scatter import column_entries

        m, n, _, _, _, _, val = _vbc1d_arrays(host)
        cols, js, rows, vidx = column_entries(host)
        order = np.lexsort((js, cols))
        colptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(cols, minlength=n), out=colptr[1:])
        return ScatterDevice(
            m=m,
            n=n,
            colptr=_i32(colptr, "colptr", device),
            row=_i32(rows[order], "row", device),
            val=torch.from_numpy(np.ascontiguousarray(
                val[vidx[order]], dtype=np.float32)).to(device),
        )

    @functools.cached_property
    def value_coords(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, col) of every entry, int64 — the index form the plain
        PyTorch TrSpMV uses (computed once per format); natural
        coordinates on a natural view."""
        counts = (self.colptr[1:] - self.colptr[:-1]).long()
        col = torch.repeat_interleave(
            torch.arange(self.n, device=self.device), counts,
            output_size=self.row.numel())
        if self.col_out is not None:
            col = self.col_out.long()[col]
        return self.row.long(), col


@dataclasses.dataclass(frozen=True)
class SemiringDevice:
    """Every stored value of a 1-D or 2-D VBC pack, the block fill
    included, with its natural (row, column), flat on a torch device, in
    the matrix's dtype or a given one: what ``ops/semiring.py`` reads for
    any matrix or vector that is not f32 (f64, int32 and bool semirings).

    Port of the JAX package's ``bin_vbc1d``/``bin_vbc2d`` formats, which
    bin and pad the stripes into width classes only so that XLA sees
    static shapes; PyTorch needs no binning.  The coordinates are the
    f32 formats' :attr:`VBC1DDevice.value_coords` (or the 2-D ones), so a
    value sits where the kernels' plain versions put it."""

    m: int
    n: int
    row: torch.Tensor  # [stored] int64 row of each stored value
    col: torch.Tensor  # [stored] int64 column of each stored value
    val: torch.Tensor  # [stored] values, the matrix's dtype or the one given

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def nbytes(self) -> int:
        return _tensor_bytes(self.row, self.col, self.val)

    def transposed(self) -> "SemiringDevice":
        """The same values as the flat format of the transpose (rows and
        columns swapped; the arrays shared)."""
        return SemiringDevice(m=self.n, n=self.m, row=self.col, col=self.row, val=self.val)

    @staticmethod
    def from_host(host, dtype=None, *, device,
                  perm: torch.Tensor | None = None) -> "SemiringDevice":
        """Flatten a host ``VBC1D`` or ``VBC2D`` (this port's or the JAX
        package's) onto ``device``, its values as ``dtype`` (default: the
        pack's own).  ``perm`` (int32 on ``device``, 1-D packs only) says
        that the pack holds ``A[perm][:, perm]``: the coordinates are then
        those of ``A`` (its natural view's), so calls read natural x and
        write natural y.  Raises ``ValueError`` on a pack the f32 formats
        refuse."""
        def dev(a):
            return torch.from_numpy(a).to(device)

        if hasattr(host, "Pi"):
            if perm is not None:
                raise ValueError("a relabeling applies to 1-D packs only")
            m, n, rspl, spl, pos, idx, _, val = _vbc2d_arrays(host)
            spl, pos = dev(spl), dev(pos)
            row, col = _coords_2d(spl, pos, *_tile_places(dev(rspl), spl, pos,
                                                          dev(idx)), val.size)
        else:
            m, n, spl, pos, idx, ofs, val = _vbc1d_arrays(host)
            row, col = _coords_1d(dev(spl), dev(pos), dev(idx), dev(ofs), val.size)
            if perm is not None:
                _check_perm(perm, n, row.device)
                if m != n:
                    raise ValueError("a natural view needs a square pack in "
                                     "relabeled order")
                perm = perm.long()
                row, col = perm[row], perm[col]
        val = np.ascontiguousarray(val, dtype=np.dtype(dtype or val.dtype))
        return SemiringDevice(m=m, n=n, row=row, col=col, val=dev(val))
