"""Partition entry points: ``pack_stripe``, ``pack_plaid``,
``AlternatingPacker``.

Port of ``vbcs_tpu/plan/alternating.py``.  It mirrors the
ChainPartitioners.jl surface the reference consumes:
``pack_stripe(A, method)`` partitions the *columns* of a CSC matrix;
``pack_plaid(A, method)`` produces a (row, column) partition pair for the
2-D format by alternating column/row optimization (reference default at
``src/constructors_VBC.jl:1-8``; harness combos at
``bin/test_table.jl:88-111``).

Pass order: pass 1 partitions columns, pass 2 rows, pass 3 columns, ... .
Row passes run the chunker on A^T; 2-D cost models for row passes are
expected pre-permuted by the caller (``model.permuted()``), exactly as the
reference passes ``permutedims(model)``.
"""

from __future__ import annotations

import dataclasses

from ..formats.csc import CSC
from ..formats.partition import SplitPartition
from ..utils import trace
from .dynamic import DynamicTotalChunker

__all__ = ["AlternatingPacker", "AlternatePacker", "pack_stripe", "pack_plaid"]


def pack_stripe(
    A: CSC, method, row_partition: SplitPartition | None = None
) -> SplitPartition:
    """Partition the columns of ``A`` with the given chunker.

    ``row_partition`` is consulted only by :class:`DynamicTotalChunker`
    carrying a 2-D (BlockComponent) cost model.
    """
    with trace.span("plan.dp"):
        if isinstance(method, DynamicTotalChunker):
            return method.partition(A, row_partition)
        return method.partition(A)


@dataclasses.dataclass(frozen=True)
class AlternatingPacker:
    """Alternate column/row partitioning passes (reference
    ``AlternatingPacker`` / ``AlternatePacker``)."""

    chunkers: tuple

    def __init__(self, *chunkers):
        object.__setattr__(self, "chunkers", tuple(chunkers))

    def pack(self, A: CSC) -> tuple[SplitPartition, SplitPartition]:
        """Returns ``(Pi, Phi)`` — row and column partitions."""
        At = A.transpose()
        Pi = SplitPartition.trivial(A.m)
        Phi = SplitPartition.trivial(A.n)
        for p, chunker in enumerate(self.chunkers):
            if p % 2 == 0:  # column pass
                Phi = pack_stripe(A, chunker, row_partition=Pi)
            else:  # row pass (chunker's model pre-permuted by caller)
                Pi = pack_stripe(At, chunker, row_partition=Phi)
        return Pi, Phi


AlternatePacker = AlternatingPacker  # reference uses both names


def pack_plaid(A: CSC, method) -> tuple[SplitPartition, SplitPartition]:
    """Row+column partition for the 2-D VBC format
    (reference ``pack_plaid`` at ``src/constructors_VBC.jl:11``)."""
    if isinstance(method, AlternatingPacker):
        return method.pack(A)
    # A single column chunker: rows stay trivial.
    return SplitPartition.trivial(A.m), pack_stripe(A, method)
