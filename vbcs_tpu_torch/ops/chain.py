"""Chain TrSpMV: ``y = (alpha * A.T)^n_iters @ x`` on a square VBC1DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv3.py``'s chain path
(``tr_spmv_chain3``; Pallas kernel ``_chain_kernel``).  On a CUDA tensor
:func:`tr_spmv_chain` makes one cooperative launch of
``csrc/chain.cu``, a persistent kernel that runs every iteration with a
grid barrier between them; on a CPU tensor it runs
:func:`tr_spmv_chain_plain`, a loop of the plain TrSpMV.

``alpha`` scales every iteration (``None`` is 1), as in the JAX kernel.
"""

from __future__ import annotations

import torch

from ..formats.device import VBC1DDevice
from . import _lib
from .trspmv import _check_vec, tr_spmv_plain

__all__ = ["tr_spmv_chain", "tr_spmv_chain_plain"]


def _check_chain(fmt, n_iters: int) -> None:
    if fmt.m != fmt.n:
        raise ValueError(f"the chain needs a square matrix, got {fmt.m}x{fmt.n}")
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")


def tr_spmv_chain_plain(fmt: VBC1DDevice, x: torch.Tensor, n_iters: int,
                        alpha=None) -> torch.Tensor:
    """Plain PyTorch chain: ``n_iters`` calls of :func:`tr_spmv_plain`,
    each scaled by ``alpha``."""
    _check_chain(fmt, n_iters)
    for _ in range(n_iters):
        x = tr_spmv_plain(fmt, x, alpha)
    return x


def tr_spmv_chain(fmt: VBC1DDevice, x: torch.Tensor, n_iters: int,
                  alpha=None) -> torch.Tensor:
    """``(alpha * A.T)^n_iters @ x`` in natural order, shape ``[n]``, for a
    square ``fmt`` and ``n_iters >= 1``.

    CUDA tensors run the persistent chain kernel in one cooperative launch
    over every block the card can hold resident at once (a refused launch
    raises ``RuntimeError``); CPU tensors run :func:`tr_spmv_chain_plain`."""
    _check_chain(fmt, n_iters)
    dev = fmt.device
    _check_vec("x", x, fmt.m, dev)
    if dev.type == "cpu":
        return tr_spmv_chain_plain(fmt, x, n_iters, alpha)
    if dev.type != "cuda":
        raise NotImplementedError(f"no chain kernel for device {dev}")
    out = torch.empty(fmt.n, dtype=torch.float32, device=dev)
    if fmt.n == 0:
        return out
    bufs = (torch.empty(2, fmt.n, dtype=torch.float32, device=dev)
            if n_iters > 1 else None)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.vbcs_tr_spmv_chain(
            fmt.n, n_iters, fmt.spl.data_ptr(), fmt.pos.data_ptr(),
            fmt.idx.data_ptr(), fmt.ofs.data_ptr(), fmt.col_stripe.data_ptr(),
            fmt.val.data_ptr(), x.data_ptr(), 1.0 if alpha is None else float(alpha),
            None if bufs is None else bufs[0].data_ptr(),
            None if bufs is None else bufs[1].data_ptr(), out.data_ptr(), 0,
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(lib, rc, "tr_spmv_chain")
    tr_spmv_chain.launches += 1
    return out


tr_spmv_chain.launches = 0
