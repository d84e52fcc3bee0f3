"""Stripe SpMM: ``Y = A.T @ X`` for a dense RHS ``X [m, k]`` on a VBC1DDevice.

Port of the JAX package's SpMM kernels, one kernel for all of them:
``vbcs_tpu/ops/pallas_spmm4.py`` (``tr_spmm_pallas4``),
``pallas_spmm3.py`` (``tr_spmm_pallas3``), ``pallas_spmm.py``
(``tr_spmm_pallas``, with its fallback to ``pallas_trspmv._run_class``)
and the XLA ``vbcs_tpu/ops/xla.py:tr_spmm``.  On a CUDA tensor
:func:`tr_spmm` launches the hand-written kernel in ``csrc/spmm.cu``; on
a CPU tensor it runs :func:`tr_spmm_plain`, the plain PyTorch version of
the same function.  The kernel's accumulator is sized by the pack's
:attr:`VBC1DDevice.width_class`, and its stripes of more than
``SPMM_LONG_BLOCKS`` blocks (:attr:`VBC1DDevice.long_stripes`) are walked
by whole thread blocks; both are computed once with the pack.
"""

from __future__ import annotations

import torch

from ..formats.device import SPMM_LONG_BLOCKS, VBC1DDevice
from ..utils import trace
from . import _lib
from .trspmv import check_tensor

__all__ = ["tr_spmm", "tr_spmm_plain"]


def tr_spmm_plain(fmt: VBC1DDevice, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SpMM: ``index_add_`` of ``val[:, None] * X[row]``
    into the value's column of Y (the value coordinates of
    :attr:`VBC1DDevice.value_coords`)."""
    row, col = fmt.value_coords
    Y = torch.zeros(fmt.n, X.shape[1], dtype=torch.float32, device=X.device)
    Y.index_add_(0, col, fmt.val[:, None] * X[row])
    return Y


def tr_spmm(fmt: VBC1DDevice, X: torch.Tensor) -> torch.Tensor:
    """``A.T @ X`` in natural order, shape ``[n, k]``, for a contiguous
    f32 ``X`` of shape ``[m, k]`` (any ``k >= 0``); on a natural view,
    column ``j`` of the pack is row ``col_out[j]`` of Y.

    CUDA tensors run the stripe SpMM kernel (or raise); CPU tensors run
    :func:`tr_spmm_plain`."""
    dev = fmt.device
    with trace.span("op.check"):
        check_tensor("X", X, (fmt.m, None), dev)
    if dev.type == "cpu":
        return tr_spmm_plain(fmt, X)
    if dev.type != "cuda":
        raise NotImplementedError(f"no SpMM kernel for device {dev}")
    k = X.shape[1]
    with trace.span("op.alloc"):
        Y = torch.empty(fmt.n, k, dtype=torch.float32, device=dev)
    if fmt.n == 0 or k == 0:
        return Y
    with trace.span("op.launch"):
        longs = fmt.long_stripes  # None: the lanes take every stripe
        n_long = 0 if longs is None else longs.numel()
        _lib.launch(tr_spmm, "vbcs_tr_spmm", dev, fmt.L, k, fmt.width_class,
                    int(fmt.quad_widths), fmt.idx.numel(), SPMM_LONG_BLOCKS, n_long,
                    longs.data_ptr() if n_long else None, fmt.spl.data_ptr(),
                    fmt.pos.data_ptr(), fmt.idx.data_ptr(), fmt.ofs.data_ptr(),
                    _lib.ptr(fmt.col_out), fmt.val.data_ptr(), X.data_ptr(), Y.data_ptr())
    return Y


tr_spmm.launches = 0
