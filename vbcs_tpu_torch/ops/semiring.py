"""Semiring SpMV and SpMM in any dtype, on CPU and CUDA tensors alike.

Port of ``vbcs_tpu/ops/xla.py`` (``tr_spmv``, ``spmv``, ``tr_spmm``,
``spmm``): the jnp kernels the JAX operators run for every matrix or
vector that is not f32 — f64 parity runs, the int32 and bool semirings
the reference tests (``test/runtests.jl:15-16``).  Those bin the pack
into static-shape width classes for XLA; here the pack is flat
(:class:`~vbcs_tpu_torch.formats.device.SemiringDevice`: each stored
value with its row and column) and each function is one gather, one
multiply in x's dtype (the matrix cast to it, as JAX's ``astype``) and
one ``index_add_`` into an output of x's dtype.

No Pallas kernel stands behind ``ops/xla.py``, so none is written by
hand here: these functions are the port's counterpart of it, not plain
versions standing in for kernels.  An f32 matrix with an f32 vector
never comes here; the kernels' wrappers refuse a vector of another
dtype than their format's values.

In the port, the 1-D operator's f64 ``tr_mul``/``mul`` run the stripe
kernel's f64 map instead; the operators send here the int32 and bool
matrices, mixed dtypes, and in f64 the chain, the SpMM and every 2-D
call (``operator.py``'s route table).  The operators count each call
that comes here (``utils.trace.semiring_calls``).

A bool x raises ``TypeError``, as JAX's ``segment_sum`` does ("add does
not accept dtype bool").
"""

from __future__ import annotations

import torch

from ..formats.device import SemiringDevice

__all__ = ["tr_spmv", "spmv", "tr_spmm", "spmm", "check_operand"]


def check_operand(name: str, t, rows: int, device, dim: int) -> None:
    """Refuse what the semiring functions do not take: a non-tensor or a
    bool tensor (``TypeError``), or a tensor of another rank, length or
    device (``ValueError``)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype == torch.bool:
        raise TypeError(f"{name} is bool: a sum of bools has no dtype "
                        f"(JAX's segment_sum refuses it too)")
    if t.dim() != dim or t.shape[0] != rows:
        raise ValueError(f"{name} must have {dim} dimension(s) and {rows} rows, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")


def _products(values: torch.Tensor, x: torch.Tensor, at: torch.Tensor):
    """``values * x[at]`` in x's dtype (a column per RHS for a 2-D x)."""
    v = values.to(x.dtype)
    return (v if x.dim() == 1 else v[:, None]) * x[at]


def tr_spmv(A: SemiringDevice, x: torch.Tensor) -> torch.Tensor:
    """``y = A.T @ x`` in x's dtype."""
    check_operand("x", x, A.m, A.device, 1)
    y = torch.zeros(A.n, dtype=x.dtype, device=A.device)
    return y.index_add_(0, A.col, _products(A.val, x, A.row))


def spmv(A: SemiringDevice, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` in x's dtype."""
    check_operand("x", x, A.n, A.device, 1)
    y = torch.zeros(A.m, dtype=x.dtype, device=A.device)
    return y.index_add_(0, A.row, _products(A.val, x, A.col))


def tr_spmm(A: SemiringDevice, X: torch.Tensor) -> torch.Tensor:
    """``Y = A.T @ X`` for a dense ``X [m, k]``, in X's dtype."""
    check_operand("X", X, A.m, A.device, 2)
    Y = torch.zeros(A.n, X.shape[1], dtype=X.dtype, device=A.device)
    return Y.index_add_(0, A.col, _products(A.val, X, A.row))


def spmm(A: SemiringDevice, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a dense ``X [n, k]``, in X's dtype."""
    check_operand("X", X, A.n, A.device, 2)
    Y = torch.zeros(A.m, X.shape[1], dtype=X.dtype, device=A.device)
    return Y.index_add_(0, A.row, _products(A.val, X, A.col))
