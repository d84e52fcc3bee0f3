"""The CSC baseline: the un-blocked comparison point of the method table.

Port of ``vbcs_tpu/ops/csr.py`` (``CSCDevice``, ``csc_tr_spmv``,
``csc_spmv``), the analog of the reference's CSC TrSpMV
(``src/TrSpMV.jl:1-20``, timed first in ``bin/test_table.jl:34-44``): a
flat gather and segment sum over the raw CSC arrays, no block structure.
Padded entries carry ``col == n`` (a dropped segment), as in the JAX
package.  Like ``ops/semiring.py`` these are jnp functions there, not
Pallas kernels, so nothing is written by hand for them: one
``index_add_`` in x's dtype, on CPU and CUDA tensors alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csc import CSC
from .semiring import check_operand

__all__ = ["CSCDevice", "csc_tr_spmv", "csc_spmv"]


@dataclasses.dataclass(frozen=True)
class CSCDevice:
    """Flattened CSC: per-nonzero column id (expanded colptr), row index,
    value.  Padded nonzeros carry col == n (dropped segment)."""

    m: int
    n: int
    col: torch.Tensor  # [nnz_pad] int64
    rowidx: torch.Tensor  # [nnz_pad] int64
    val: torch.Tensor  # [nnz_pad]

    @property
    def device(self) -> torch.device:
        return self.val.device

    @staticmethod
    def from_host(A: CSC, dtype=None, pad: int = 8, *, device) -> "CSCDevice":
        """``A``'s entries padded to a multiple of ``pad`` (at least one
        ``pad``), values as ``dtype`` (default: ``A``'s), on ``device``."""
        dtype = np.dtype(dtype or A.val.dtype)
        nnz = A.nnz
        nnz_pad = max(pad, -(-nnz // pad) * pad)
        col = np.full(nnz_pad, A.n, dtype=np.int64)
        col[:nnz] = np.repeat(np.arange(A.n, dtype=np.int64), np.diff(A.pos))
        rowidx = np.zeros(nnz_pad, dtype=np.int64)
        rowidx[:nnz] = A.idx
        val = np.zeros(nnz_pad, dtype=dtype)
        val[:nnz] = A.val.astype(dtype)
        return CSCDevice(m=A.m, n=A.n, col=torch.from_numpy(col).to(device),
                         rowidx=torch.from_numpy(rowidx).to(device),
                         val=torch.from_numpy(val).to(device))

    @property
    def nbytes(self) -> int:
        """Bytes of the three arrays on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.col, self.rowidx, self.val))


def csc_tr_spmv(A: CSCDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: gather x at row indices, segment-sum by column."""
    check_operand("x", x, A.m, A.device, 1)
    prod = A.val.to(x.dtype) * x[A.rowidx]
    y = torch.zeros(A.n + 1, dtype=x.dtype, device=A.device)
    return y.index_add_(0, A.col, prod)[: A.n]


def csc_spmv(A: CSCDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather x at columns (a padded entry reads 0), scatter-add
    by row."""
    check_operand("x", x, A.n, A.device, 1)
    xg = torch.cat([x, x.new_zeros(1)])[A.col]
    y = torch.zeros(A.m, dtype=x.dtype, device=A.device)
    return y.index_add_(0, A.rowidx, A.val.to(x.dtype) * xg)
