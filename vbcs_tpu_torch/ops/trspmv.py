"""Stripe TrSpMV: ``y = alpha * A.T @ x (+ beta * y)`` on a VBC1DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv3.py``'s one-shot path
(``tr_spmv_oneshot3``; Pallas kernel ``_oneshot_kernel``).  On a CUDA
tensor :func:`tr_spmv` launches the hand-written kernel in
``csrc/trspmv.cu``; on a CPU tensor it runs :func:`tr_spmv_plain`, the
plain PyTorch version of the same function.

Alpha/beta follow the JAX kernel: ``alpha=None`` is 1; ``beta * y`` is
added only when both ``beta`` and ``y`` are given.

``out=`` writes into a given buffer through the format's ``col_out``, an
injection into ``[0, out.numel())``: two launches on two formats whose
``col_out`` are disjoint fill one buffer (the overlapped halo path's
local and remote stripes, ``parallel/stream.py``).
"""

from __future__ import annotations

import torch

from ..formats.device import VBC1DDevice
from ..utils import trace
from . import _lib

__all__ = ["tr_spmv", "tr_spmv_plain"]


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Refuse what the kernels do not take: anything but a contiguous f32
    tensor of ``shape`` (``None`` matches any extent) on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        want = ", ".join("k" if w is None else str(w) for w in shape)
        want += "," if len(shape) == 1 else ""
        raise ValueError(f"{name} must have shape ({want}), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_vec(name: str, t: torch.Tensor, size: int, device) -> None:
    _check_tensor(name, t, (size,), device)


def tr_spmv_plain(fmt, x: torch.Tensor, alpha=None, beta=None,
                  y=None, out=None) -> torch.Tensor:
    """Plain PyTorch TrSpMV: ``index_add_`` of ``val * x[row]`` into the
    value's column.  ``fmt`` is any device format with ``n``, ``val`` and
    ``value_coords`` (computed once per format); with ``out``, the
    columns land in it at ``col_out`` and its other entries are kept."""
    row, col = fmt.value_coords
    acc = torch.zeros(fmt.n if out is None else out.numel(), dtype=torch.float32,
                      device=x.device)
    acc.index_add_(0, col, fmt.val * x[row])
    if alpha is not None:
        acc = acc * alpha
    if y is not None and beta is not None:
        acc = acc + beta * y
    if out is None:
        return acc
    place = (torch.arange(fmt.n, device=out.device) if fmt.col_out is None
             else fmt.col_out.long())
    out[place] = acc[place]
    return out


def _check_out(fmt, out) -> None:
    """``out`` must hold every output column: ``n`` entries in natural
    order, at least ``n`` under ``col_out`` (an injection into them)."""
    _check_tensor("out", out, (None,), fmt.device)
    if out.numel() < fmt.n or (fmt.col_out is None and out.numel() != fmt.n):
        raise ValueError(f"out has {out.numel()} entries for {fmt.n} columns "
                         f"({'placed by col_out' if fmt.col_out is not None else 'in order'})")


def _run_tr_spmv(kernel, plain, fmt, x, alpha, beta, y, launch,
                 out=None) -> torch.Tensor:
    """The body every TrSpMV wrapper shares.  Checks ``x`` (and ``y`` when
    ``beta`` is given; shaped like the output), runs ``plain`` on a CPU
    tensor, and on a CUDA tensor allocates the output (unless ``out`` is
    given: only :func:`tr_spmv` takes one) and calls ``launch(lib, y_in,
    alpha, beta, out, stream)`` (device pointers and the stream as ints),
    raises if the launch failed, and counts it in ``kernel.launches``."""
    dev = fmt.device
    with trace.span("op.check"):
        _check_vec("x", x, fmt.m, dev)
        if out is not None:
            _check_out(fmt, out)
        with_y = y is not None and beta is not None
        if with_y:
            _check_vec("y", y, fmt.n if out is None else out.numel(), dev)
    if dev.type == "cpu":
        if out is None:
            return plain(fmt, x, alpha, beta, y)
        return plain(fmt, x, alpha, beta, y, out)
    if dev.type != "cuda":
        raise NotImplementedError(f"no {kernel.__name__} kernel for device {dev}")
    if out is None:
        with trace.span("op.alloc"):
            out = torch.empty(fmt.n, dtype=torch.float32, device=dev)
    if fmt.n == 0:
        return out
    with trace.span("op.launch"):
        lib = _lib.load()
        with torch.cuda.device(dev):
            rc = launch(lib, y.data_ptr() if with_y else None,
                        1.0 if alpha is None else float(alpha),
                        float(beta) if with_y else 0.0, out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(lib, rc, kernel.__name__)
    kernel.launches += 1
    return out


def tr_spmv(fmt: VBC1DDevice, x: torch.Tensor, alpha=None, beta=None,
            y=None, out=None) -> torch.Tensor:
    """``alpha * A.T @ x (+ beta * y)`` in natural order, shape ``[n]``
    (on a natural view, output column ``j`` lands at ``col_out[j]``).
    With ``out`` (f32, ``[k]``), column ``j`` lands at ``out[col_out[j]]``
    (``col_out`` an injection into ``[0, k)``, unchecked on the card;
    ``k = n`` without one) and ``out`` is returned; ``y``, where given,
    is shaped like it.

    CUDA tensors run the stripe kernel (or raise); CPU tensors run
    :func:`tr_spmv_plain`."""
    return _run_tr_spmv(
        tr_spmv, tr_spmv_plain, fmt, x, alpha, beta, y,
        lambda lib, *rest: lib.vbcs_tr_spmv(
            fmt.n, fmt.L, int(fmt.quad_widths), fmt.spl.data_ptr(),
            fmt.pos.data_ptr(), fmt.idx.data_ptr(), fmt.ofs.data_ptr(),
            fmt.col_stripe.data_ptr(),
            None if fmt.col_out is None else fmt.col_out.data_ptr(),
            fmt.val.data_ptr(), x.data_ptr(), *rest), out)


tr_spmv.launches = 0
