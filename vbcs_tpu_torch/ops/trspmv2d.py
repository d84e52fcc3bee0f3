"""2-D tile TrSpMV: ``y = alpha * A.T @ x (+ beta * y)`` on a VBC2DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv2d.py`` (``tr_spmv_pallas_2d``;
Pallas kernel ``_class_kernel2d``) together with the 1-D stream route it
sends mixed-height stripes to (``pallas_trspmv2.tr_spmv_slots``; Pallas
kernel ``_class_kernel2``).  On a CUDA tensor :func:`tr_spmv_2d` launches
the hand-written kernel in ``csrc/trspmv2d.cu``, which reads each tile's
height and so takes every stripe; on a CPU tensor it runs
:func:`tr_spmv_2d_plain`, the plain PyTorch version of the same function.

Alpha/beta follow the stripe kernel's wrapper (``ops/trspmv.py``):
``alpha=None`` is 1; ``beta * y`` is added only when both ``beta`` and
``y`` are given.
"""

from __future__ import annotations

import torch

from ..formats.device import VBC2DDevice
from .trspmv import _run_tr_spmv, tr_spmv_plain

__all__ = ["tr_spmv_2d", "tr_spmv_2d_plain"]


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
        lambda lib, *rest: lib.vbcs_tr_spmv_2d(
            fmt.n, fmt.rspl.data_ptr(), fmt.spl.data_ptr(), fmt.pos.data_ptr(),
            fmt.idx.data_ptr(), fmt.ofs.data_ptr(), fmt.col_stripe.data_ptr(),
            fmt.val.data_ptr(), x.data_ptr(), *rest))


tr_spmv_2d.launches = 0
