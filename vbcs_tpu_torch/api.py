"""High-level constructors.

Port of ``vbcs_tpu/api.py``: the reference's
``SparseMatrix1DVBC{W}(A, method)`` / ``SparseMatrixVBC{U,W}(A, method)``
entry points (``src/constructors_1DVBC.jl:1-7``,
``src/constructors_VBC.jl:1-13``).
"""

from __future__ import annotations

from .formats.csc import CSC
from .formats.partition import SplitPartition
from .formats.vbc1d import VBC1D, pack_1dvbc
from .formats.vbc2d import VBC2D, pack_vbc2d
from .models.cost import (
    ConstrainedCost,
    VertexCount,
    model_1dvbc_memory,
    model_vbc_memory,
)
from .plan.alternating import AlternatingPacker, pack_plaid, pack_stripe
from .plan.chunkers import EquiChunker
from .plan.dynamic import DynamicTotalChunker

__all__ = [
    "default_1d_partitioner",
    "default_2d_partitioner",
    "vbc1d",
    "vbc2d",
]


def default_1d_partitioner(W: int, val_itemsize: int = 8, idx_itemsize: int = 8):
    """Min-memory DP (reference ``default_partitioner`` at
    ``src/constructors_1DVBC.jl:1-2``, which also defaults to its MEMORY
    model; the autotuned min-time model is a harness-level choice there,
    ``bin/test_table.jl:50-52``, and here:
    ``DynamicTotalChunker(model_1dvbc_trspmv_time(W, device="cuda"), W)``,
    loadable cache-only with ``require_cache=True``; the method table,
    ``python -m vbcs_tpu_torch.tools.method_table``, sets the two plans
    side by side on the card)."""
    return DynamicTotalChunker(model_1dvbc_memory(val_itemsize, idx_itemsize), W)


def default_2d_partitioner(U: int, W: int, val_itemsize: int = 8, idx_itemsize: int = 8):
    """Five-pass alternating min-memory optimization (reference
    ``default_partitioner`` at ``src/constructors_VBC.jl:1-8``)."""
    mem = model_vbc_memory(val_itemsize, idx_itemsize)
    return AlternatingPacker(
        EquiChunker(),
        EquiChunker(),
        DynamicTotalChunker(ConstrainedCost(mem, VertexCount(), W)),
        DynamicTotalChunker(ConstrainedCost(mem.permuted(), VertexCount(), U)),
        DynamicTotalChunker(ConstrainedCost(mem, VertexCount(), W)),
    )


def vbc1d(A, W: int, method=None) -> VBC1D:
    """Build a 1D-VBC matrix from CSC (or anything scipy can convert)."""
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    if not isinstance(A, CSC):
        A = CSC.from_scipy(A)
    if isinstance(method, SplitPartition):
        return pack_1dvbc(A, method, W)
    if method is None:
        method = default_1d_partitioner(W, A.val.dtype.itemsize)
    Phi = pack_stripe(A, method)
    return pack_1dvbc(A, Phi, W)


def vbc2d(A, U: int, W: int, method=None) -> VBC2D:
    """Build a 2-D VBC matrix from CSC (or anything scipy can convert).

    ``method`` is a chunker, an :class:`AlternatingPacker`, or an explicit
    ``(Pi, Phi)`` pair of partitions."""
    if U < 1 or W < 1:
        raise ValueError(f"U and W must be >= 1, got U={U}, W={W}")
    if not isinstance(A, CSC):
        A = CSC.from_scipy(A)
    if isinstance(method, tuple):
        Pi, Phi = method
        return pack_vbc2d(A, Pi, Phi, U, W)
    if method is None:
        method = default_2d_partitioner(U, W, A.val.dtype.itemsize)
    Pi, Phi = pack_plaid(A, method)
    return pack_vbc2d(A, Pi, Phi, U, W)
