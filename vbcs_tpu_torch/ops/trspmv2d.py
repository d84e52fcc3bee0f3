"""2-D tile TrSpMV: ``y = alpha * A.T @ x (+ beta * y)`` on a VBC2DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv2d.py`` (``tr_spmv_pallas_2d``;
Pallas kernel ``_class_kernel2d``) together with the 1-D stream route it
sends mixed-height stripes to (``pallas_trspmv2.tr_spmv_slots``; Pallas
kernel ``_class_kernel2``).  On a CUDA tensor :func:`tr_spmv_2d` launches
the hand-written kernel in ``csrc/trspmv2d.cu`` with
:func:`lanes_per_stripe` lanes a stripe; it reads each tile's place from
the pack's ``tile_row``/``tile_ofs`` and so takes tiles of any height;
on a CPU tensor it runs :func:`tr_spmv_2d_plain`, the plain PyTorch
version of the same function.

Alpha/beta follow the stripe kernel's wrapper (``ops/trspmv.py``):
``alpha=None`` is 1; ``beta * y`` is added only when both ``beta`` and
``y`` are given.
"""

from __future__ import annotations

import math

import torch

from ..formats.device import VBC2DDevice
from . import _lib
from .trspmv import _run_tr_spmv, tr_spmv_plain

__all__ = ["tr_spmv_2d", "tr_spmv_2d_plain", "lanes_per_stripe"]

VALUES_PER_LANE = 16  # the stored values a lane of the tile kernel aims at


def lanes_per_stripe(fmt: VBC2DDevice) -> int:
    """The tile kernel's lane group (1, 2, ..., 32 lanes a stripe): the
    power of two that covers the mean stripe width and gives each lane
    about ``VALUES_PER_LANE`` stored values, at most a warp."""
    L = max(1, fmt.L)
    want = max(1.0, fmt.n / L, fmt.val.numel() / (L * VALUES_PER_LANE))
    return min(32, 1 << (math.ceil(want) - 1).bit_length())


def tr_spmv_2d_plain(fmt: VBC2DDevice, x: torch.Tensor, alpha=None, beta=None,
                     y=None) -> torch.Tensor:
    """Plain PyTorch 2-D TrSpMV: ``index_add_`` of ``val * x[row]`` over
    :attr:`VBC2DDevice.value_coords`."""
    return tr_spmv_plain(fmt, x, alpha, beta, y)


def tr_spmv_2d(fmt: VBC2DDevice, x: torch.Tensor, alpha=None, beta=None,
               y=None) -> torch.Tensor:
    """``alpha * A.T @ x (+ beta * y)`` in natural order, shape ``[n]``.

    CUDA tensors run the tile kernel (or raise); CPU tensors run
    :func:`tr_spmv_2d_plain`."""
    return _run_tr_spmv(
        tr_spmv_2d, tr_spmv_2d_plain, fmt, x, alpha, beta, y,
        lambda *tail: _lib.launch(
            tr_spmv_2d, "vbcs_tr_spmv_2d", fmt.device, fmt.L, lanes_per_stripe(fmt),
            fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.tile_row.data_ptr(),
            fmt.tile_ofs.data_ptr(), fmt.val.data_ptr(), x.data_ptr(), *tail))


tr_spmv_2d.launches = 0
