"""Ordered scatter: ``Y = alpha * A @ X (+ beta * Y_in)`` on A's own pack.

Replaces no TPU kernel.  The JAX package computes ``A @ X`` as
``(A.T).T @ X`` on the pack of ``A.T`` (its SpMM kernels, which
``ops/spmm.py`` ports): one X row read for every block of that pack.  On
a pack of ``A`` itself each stripe's columns are rows of X, read once,
and each of its blocks (a one-row slice of A) gives a whole row of
products for one row of Y.  A row of Y that several blocks meet takes
their sum in a second launch, in a fixed order and without atomics, so Y
has the same bits on every call:

* products: each block's row ``P_b = sum_i val[b, i] * X[col_i]`` goes
  whole to its row of Y (``alpha * P_b (+ beta * Y_in)``) where it is
  its row's only block, else to its slot of a partial buffer;
* rows: each row of several blocks gets ``alpha`` times the sum of its
  slots in stripe order (``+ beta * Y_in``), each empty row 0 (or
  ``beta * Y_in``).

Below ``k = SECTOR_COLUMNS`` (8) a row of Y is narrower than the 32-byte
sector a store at a random row costs, so both launches run *by block*:
block b's row goes to slot b (in block order, whole sectors), and the
rows launch sums every row's blocks through :attr:`VBC1DDevice.row_blocks`
(built on the first such call) in the same order, so Y has the same bits
either way.

The maps are :attr:`VBC1DDevice.ordered_maps` (``formats/device.py``),
built once with the pack.  On a natural view (auto-RCM) the stripes read
X through ``col_out`` and the maps hold natural rows, so both launches
write natural order.  On a CUDA tensor :func:`mul_ordered` launches the
two kernels of ``csrc/ordered.cu`` (``mul_ordered.launches`` counts each,
and ``utils.trace.launches_by_map`` counts them as ``"ordered_products"``
and ``"ordered_rows"``); on a CPU tensor it runs
:func:`mul_ordered_plain`, the plain PyTorch version of the same
function through the same maps.  Alpha/beta follow ``ops/trspmv.py``:
``alpha=None`` is 1, ``beta * y`` is added only when both are given.
"""

from __future__ import annotations

import torch

from ..formats.device import SPMM_LONG_BLOCKS, VBC1DDevice
from ..utils import trace
from . import _lib
from .trspmv import check_tensor

__all__ = ["mul_ordered", "mul_ordered_plain", "launch_products", "launch_rows",
           "SECTOR_COLUMNS"]

SECTOR_COLUMNS = 8  # f32 columns in a 32-byte sector: below, the launches run by block


def mul_ordered_plain(fmt: VBC1DDevice, X: torch.Tensor, alpha=None, beta=None,
                      y=None) -> torch.Tensor:
    """Plain PyTorch ordered scatter through the maps the kernels read:
    each block's row of products by an ``index_add_`` of its values'
    ``val * X[col]``; then, below ``SECTOR_COLUMNS`` columns, every row's
    blocks summed through :attr:`VBC1DDevice.row_blocks`, else the rows of
    one block placed and the slots of the others summed into their rows
    through :attr:`VBC1DDevice.ordered_maps`.  ``X`` is ``[n, k]`` or a
    vector ``[n]`` (then Y is ``[m]``)."""
    X2 = X[:, None] if X.dim() == 1 else X
    k, dev = X2.shape[1], X.device
    blk, col = fmt.value_blocks
    P = torch.zeros(fmt.idx.numel(), k, dtype=torch.float32, device=dev)
    P.index_add_(0, blk, fmt.val[:, None] * X2[col])
    Y = torch.zeros(fmt.m, k, dtype=torch.float32, device=dev)

    def rows_of(ptr, count):  # the row of each entry of a row-pointer array
        return torch.repeat_interleave(torch.arange(fmt.m, device=dev),
                                       ptr[1:] - ptr[:-1], output_size=count)

    if k < SECTOR_COLUMNS:
        rb = fmt.row_blocks
        Y.index_add_(0, rows_of(rb.start.long(), rb.blocks.numel()), P[rb.blocks.long()])
    else:
        maps = fmt.ordered_maps
        dest = maps.dest.long()
        one = dest >= 0
        part = torch.empty(maps.slots, k, dtype=torch.float32, device=dev)
        part[-dest[~one] - 1] = P[~one]
        v = maps.row_ptr.long()
        Y[dest[one]] = P[one]
        Y.index_add_(0, rows_of(torch.where(v >= 0, v, -v - 1), maps.slots), part)
    Y = Y[:, 0] if X.dim() == 1 else Y
    if alpha is not None:
        Y = Y * alpha
    if y is not None and beta is not None:
        Y = Y + beta * y
    return Y


def launch_products(fmt: VBC1DDevice, X: torch.Tensor, Y: torch.Tensor,
                    part: torch.Tensor, y_in=None, alpha: float = 1.0,
                    beta: float = 0.0, by_block: bool = False) -> None:
    """The products launch of :func:`mul_ordered` on CUDA tensors, unchecked:
    each block's row of products into ``Y`` (``[m, k]`` or ``[m]``, the rows
    of one block) or ``part`` (a row of k floats a slot); ``y_in`` a tensor
    shaped like ``Y`` or None; ``by_block``: every block's row to slot b."""
    longs = fmt.long_stripes  # None: the lanes take every stripe
    n_long = 0 if longs is None else longs.numel()
    k = 1 if X.dim() == 1 else X.shape[1]
    _lib.launch(mul_ordered, "vbcs_ordered_products", fmt.device, fmt.L, k,
                int(fmt.quad_widths), SPMM_LONG_BLOCKS, n_long,
                longs.data_ptr() if n_long else None, fmt.spl.data_ptr(),
                fmt.pos.data_ptr(), fmt.ofs.data_ptr(), _lib.ptr(fmt.col_out),
                None if by_block else fmt.ordered_maps.dest.data_ptr(),
                fmt.val.data_ptr(), X.data_ptr(),
                _lib.ptr(y_in), alpha, beta, Y.data_ptr(), part.data_ptr())
    trace.tally("launches_by_map", "ordered_products")


def launch_rows(fmt: VBC1DDevice, k: int, Y: torch.Tensor, part: torch.Tensor,
                y_in=None, alpha: float = 1.0, beta: float = 0.0,
                by_block: bool = False) -> None:
    """The rows launch of :func:`mul_ordered`, after :func:`launch_products`
    on the same stream and buffers: the rows of Y with no block or
    several, or ``by_block`` every row."""
    if by_block:
        rows, blk = fmt.row_blocks.start.data_ptr(), fmt.row_blocks.blocks.data_ptr()
    else:
        rows, blk = fmt.ordered_maps.row_ptr.data_ptr(), None
    _lib.launch(mul_ordered, "vbcs_ordered_rows", fmt.device, fmt.m, k, rows, blk,
                part.data_ptr(), _lib.ptr(y_in), alpha, beta, Y.data_ptr())
    trace.tally("launches_by_map", "ordered_rows")


def mul_ordered(fmt: VBC1DDevice, X: torch.Tensor, alpha=None, beta=None,
                y=None) -> torch.Tensor:
    """``alpha * A @ X (+ beta * y)`` in natural order for a pack of ``A``
    (``m x n``; a natural view too) and a contiguous f32 ``X`` of shape
    ``[n, k]`` (any ``k >= 0``) or ``[n]``; ``y``, where given, is shaped
    like the result, ``[m, k]`` or ``[m]``.

    CUDA tensors run the two launches of ``csrc/ordered.cu`` (or raise);
    CPU tensors run :func:`mul_ordered_plain`."""
    dev = fmt.device
    vec = isinstance(X, torch.Tensor) and X.dim() == 1
    with trace.span("op.check"):
        check_tensor("X", X, (fmt.n,) if vec else (fmt.n, None), dev)
        with_y = y is not None and beta is not None
        if with_y:
            check_tensor("y", y, (fmt.m,) if vec else (fmt.m, X.shape[1]), dev)
    if dev.type == "cpu":
        return mul_ordered_plain(fmt, X, alpha, beta, y)
    if dev.type != "cuda":
        raise NotImplementedError(f"no ordered scatter kernel for device {dev}")
    k = 1 if vec else X.shape[1]
    by_block = k < SECTOR_COLUMNS
    if by_block:
        with trace.span("op.route"):
            fmt.row_blocks  # built on the first call
    slots = fmt.idx.numel() if by_block else fmt.ordered_maps.slots
    with trace.span("op.alloc"):
        Y = torch.empty((fmt.m,) if vec else (fmt.m, k), dtype=torch.float32, device=dev)
        part = torch.empty(slots * k, dtype=torch.float32, device=dev)
    if fmt.m == 0 or k == 0:
        return Y
    y_in, b = (y, float(beta)) if with_y else (None, 0.0)
    a = 1.0 if alpha is None else float(alpha)
    with trace.span("op.launch"):
        if fmt.idx.numel():
            launch_products(fmt, X, Y, part, y_in, a, b, by_block)
        if by_block or fmt.ordered_maps.rows_pass:
            launch_rows(fmt, k, Y, part, y_in, a, b, by_block)
    return Y


mul_ordered.launches = 0
