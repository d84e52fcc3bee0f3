"""The plain reference: the products a cell's calls compute, in float64
(or, for the control, in TF32), worked out again from the generated
matrix with plain torch operations, a block of nonzeros at a time.

It imports nothing of the port and reads nothing the port made: it
takes the ``scipy.sparse`` CSC the generator returned, the benchmark's
own inputs and, only to judge them, the port's outputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Matrix", "round_tf32"]

# nonzeros a block: bounds the gathered operands at BLOCK * k * 8 bytes
BLOCK = 1 << 22


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest,
    ties to even, as the tensor cores read a float32 operand."""
    b = t.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


class Matrix:
    """``A`` as coordinate arrays on ``device``: ``A @ X`` and ``A.T @ X``
    by a gather and an ``index_add_``, in ``dtype`` (float64; the control
    float32 with TF32 operands)."""

    def __init__(self, A, device, dtype=torch.float64, tf32=False):
        A = A.tocsc()
        self.m, self.n = A.shape
        self.nnz = int(A.nnz)
        self.dtype = dtype
        self.tf32 = tf32
        cols = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(A.indptr))
        self.rows = torch.from_numpy(A.indices.astype(np.int32)).to(device)
        self.cols = torch.from_numpy(cols).to(device)
        vals = torch.from_numpy(np.asarray(A.data)).to(device)
        self.vals = self._operand(vals)

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(t.to(torch.float32))
        return t.to(self.dtype)

    def product(self, X: torch.Tensor, transpose: bool) -> torch.Tensor:
        """``A.T @ X`` (``transpose``) or ``A @ X`` for ``X`` of shape
        ``[k]`` or ``[k, c]``, in the matrix's precision."""
        src, dst = (self.rows, self.cols) if transpose else (self.cols, self.rows)
        size = self.n if transpose else self.m
        X = self._operand(X)
        out = torch.zeros((size,) + tuple(X.shape[1:]), dtype=self.dtype,
                          device=X.device)
        for lo in range(0, self.nnz, BLOCK):
            hi = min(lo + BLOCK, self.nnz)
            v = self.vals[lo:hi]
            g = X[src[lo:hi].long()]
            prod = g * (v if X.dim() == 1 else v[:, None])
            out.index_add_(0, dst[lo:hi].long(), prod)
        return out

    def chain(self, x: torch.Tensor, n_iters: int, alpha) -> torch.Tensor:
        """``(alpha * A.T)^n_iters @ x``, alpha applied every iteration."""
        a = 1.0 if alpha is None else float(alpha)
        y = x
        for _ in range(n_iters):
            y = self.product(y, transpose=True) * a
            if self.tf32:
                y = y.to(torch.float32)
        return y
