"""Partition cost models for 1-D and 2-D VBC plans.

Port of ``vbcs_tpu/models/cost.py`` (NumPy).  It carries the cost-model
protocol the reference planner consumes (ChainPartitioners
model carriers + the concrete models built in reference ``src/costs.jl``):

* :class:`Line` — affine functor ``a + b*x`` (``src/costs.jl:1-6``);
* :class:`ColumnBlockComponentCostModel` — 1-D stripe cost
  ``alpha(w) + num_blocks * beta(w)`` where ``alpha``/``beta`` are
  width-indexed (Line, scalar, or per-width table);
* :class:`BlockComponentCostModel` — 2-D cost with separable rank-R block
  term ``sum_r beta_row[r](u) * beta_col[r](w)`` plus per-row-block and
  per-stripe affine terms;
* :class:`AffineConnectivityModel` / :class:`AffineFillNetCostModel` —
  netlist-style stripe costs (vertices = columns, pins = nonzeros,
  nets = distinct rows, fill = nets * w);
* :class:`ConstrainedCost` / :class:`VertexCount` — the width-cap wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Union

import numpy as np

from ..formats.partition import SplitPartition

__all__ = [
    "Line",
    "ColumnBlockComponentCostModel",
    "BlockComponentCostModel",
    "AffineConnectivityModel",
    "AffineFillNetCostModel",
    "ConstrainedCost",
    "VertexCount",
    "model_1dvbc_blocks",
    "model_1dvbc_memory",
    "model_vbc_blocks",
    "model_vbc_memory",
    "total_value",
    "row_component_value",
]


@dataclasses.dataclass(frozen=True)
class Line:
    """Affine functor ``a + b * x`` (reference ``src/costs.jl:1-6``)."""

    a: float
    b: float

    def __call__(self, x):
        return self.a + self.b * x


Component = Union[float, int, Line, Callable, Sequence]


def component_at(c: Component, x: int):
    """Evaluate a cost component at block dimension ``x`` (1-based size).

    Accepts scalars (constant), :class:`Line`, callables, or per-size
    lookup tables (``c[x - 1]`` — table index 0 is size 1), mirroring how
    ChainPartitioners' ``block_component`` dispatches.
    """
    if isinstance(c, Line):
        return c(x)
    if isinstance(c, (int, float, np.floating, np.integer)):
        return float(c)
    if callable(c):
        return c(x)
    tbl = np.asarray(c)
    if x - 1 >= tbl.shape[0]:
        raise ValueError(
            f"cost table of length {tbl.shape[0]} has no entry for block "
            f"size {x}; constrain the other dimension (U/W) with a prior "
            f"Equi pass or extend the table"
        )
    return float(tbl[x - 1])


def component_table(c: Component, max_x: int) -> np.ndarray:
    """Tabulate a component for sizes 1..max_x (vectorized DP helper)."""
    return np.array([component_at(c, x) for x in range(1, max_x + 1)], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ColumnBlockComponentCostModel:
    """1-D model: stripe cost = alpha(w) + num_blocks * beta(w).

    Reference: ``ColumnBlockComponentCostModel{Tv}(alpha_col, beta_col)``;
    built at ``src/costs.jl:10`` (memory) and ``:12`` (autotuned time).
    The JAX package's ``gamma_col`` per-group term, fit for its TPU
    stream kernel, waits for a GPU autotuner (ROADMAP.md)."""

    alpha_col: Component
    beta_col: Component

    def stripe_cost(self, w: int, num_blocks, nnz=0):
        return component_at(self.alpha_col, w) + num_blocks * component_at(
            self.beta_col, w
        )

    def alpha_table(self, W: int) -> np.ndarray:
        return component_table(self.alpha_col, W)

    def beta_table(self, W: int) -> np.ndarray:
        return component_table(self.beta_col, W)


@dataclasses.dataclass(frozen=True)
class BlockComponentCostModel:
    """2-D model (reference ``BlockComponentCostModel{Tv}``):

    total = sum_k alpha_row(u_k)
          + sum_l [ alpha_col(w_l)
                    + sum_{blocks (k,l)} sum_r beta_row[r](u_k) * beta_col[r](w_l) ].

    ``beta_row``/``beta_col`` are rank-R tuples of components; the block
    term is separable so the column DP only needs R weighted distinct-
    row-block counters (see reference ``src/costs.jl:279-284`` for the
    rank-R SVD factorization of the autotuned beta grid).
    """

    alpha_row: Component
    alpha_col: Component
    beta_row: tuple
    beta_col: tuple

    def __post_init__(self):
        if len(self.beta_row) != len(self.beta_col):
            raise ValueError("beta_row and beta_col must have equal rank")

    @property
    def rank(self) -> int:
        return len(self.beta_row)

    def block_cost(self, u: int, w: int):
        return sum(
            component_at(self.beta_row[r], u) * component_at(self.beta_col[r], w)
            for r in range(self.rank)
        )

    def permuted(self) -> "BlockComponentCostModel":
        """Swap row/column roles (reference ``permutedims(model)``,
        used at ``src/constructors_VBC.jl:6``)."""
        return BlockComponentCostModel(
            alpha_row=self.alpha_col,
            alpha_col=self.alpha_row,
            beta_row=self.beta_col,
            beta_col=self.beta_row,
        )


@dataclasses.dataclass(frozen=True)
class AffineConnectivityModel:
    """Netlist-affine stripe cost:

    cost = alpha + beta_vertex * w + beta_pin * nnz + beta_net * distinct_rows.

    ``model_SparseMatrix1DVBC_blocks() = AffineConnectivityModel(0,0,0,1)``
    (reference ``src/costs.jl:8``) counts one per distinct row per stripe,
    i.e. the number of blocks.
    """

    alpha: float
    beta_vertex: float
    beta_pin: float
    beta_net: float

    def stripe_cost(self, w: int, num_blocks, nnz=0):
        return (
            self.alpha
            + self.beta_vertex * w
            + self.beta_pin * nnz
            + self.beta_net * num_blocks
        )


@dataclasses.dataclass(frozen=True)
class AffineFillNetCostModel:
    """cost = alpha + beta_vertex * w + beta_net * nets + beta_fill * nets * w.

    The reference benchmark tables label the min-memory DP with
    ``AffineFillNetCostModel(24, 0, 8, 8)`` (BASELINE.md) — equivalent to
    the Float64/Int64 memory model below.
    """

    alpha: float
    beta_vertex: float
    beta_net: float
    beta_fill: float

    def stripe_cost(self, w: int, num_blocks, nnz=0):
        return (
            self.alpha
            + self.beta_vertex * w
            + self.beta_net * num_blocks
            + self.beta_fill * num_blocks * w
        )


class VertexCount:
    """Width widget for :class:`ConstrainedCost`: the constrained quantity
    is the number of columns (vertices) in a stripe."""


@dataclasses.dataclass(frozen=True)
class ConstrainedCost:
    """Cap the per-stripe widget (width) at ``cap`` while minimizing
    ``model`` — reference ``ConstrainedCost(model, VertexCount(), W)``
    (``test/runtests.jl:22-24``)."""

    model: object
    widget: object
    cap: int

    def stripe_cost(self, w: int, num_blocks, nnz=0):
        return self.model.stripe_cost(w, num_blocks, nnz)


# ---- concrete models (reference src/costs.jl) ------------------------------


def model_1dvbc_blocks() -> AffineConnectivityModel:
    """Minimize total block count (reference ``src/costs.jl:8``)."""
    return AffineConnectivityModel(0, 0, 0, 1)


def model_1dvbc_memory(val_itemsize: int = 8, idx_itemsize: int = 8):
    """Minimize format bytes: 3 index words per stripe (Phi/pos/ofs entries)
    plus ``idx_itemsize + w * val_itemsize`` per block
    (reference ``src/costs.jl:10``)."""
    return ColumnBlockComponentCostModel(
        alpha_col=3 * idx_itemsize,
        beta_col=Line(idx_itemsize, val_itemsize),
    )


def model_vbc_blocks() -> BlockComponentCostModel:
    """2-D block count (reference ``src/costs.jl:138``)."""
    return BlockComponentCostModel(0, 0, (1,), (1,))


def model_vbc_memory(val_itemsize: int = 8, idx_itemsize: int = 8):
    """2-D memory: one index word per row block (Pi entry), 3 per stripe,
    ``idx_itemsize + u * w * val_itemsize`` per block
    (reference ``src/costs.jl:140``)."""
    return BlockComponentCostModel(
        alpha_row=idx_itemsize,
        alpha_col=3 * idx_itemsize,
        beta_row=(Line(1, 0), Line(0, 1)),
        beta_col=(Line(idx_itemsize, 0), Line(0, val_itemsize)),
    )


# ---- evaluators (reference ChainPartitioners total_value) ------------------


def total_value(A, Phi, model, Pi=None):
    """Total modeled cost of a (row,) column partition of CSC matrix ``A``.

    1-D models: ``total_value(A, Phi, model)``.
    2-D models: ``total_value(A, Phi, model, Pi=...)`` sums the separable
    block term + alpha_col per stripe (add :func:`row_component_value`
    for the alpha_row part, as the reference harness does at
    ``bin/test_table.jl:124``).
    """
    base = unwrap(model)
    spl = Phi.spl
    total = 0.0
    if isinstance(base, BlockComponentCostModel):
        if Pi is None:
            Pi = SplitPartition.trivial(A.m)
        asg = Pi.to_map().asg
        heights = Pi.widths()
        for l in range(len(Phi)):
            j0, j1 = int(spl[l]), int(spl[l + 1])
            w = j1 - j0
            ks = np.unique(asg[A.idx[A.pos[j0] : A.pos[j1]]])
            total += component_at(base.alpha_col, w) if w > 0 else 0.0
            for k in ks:
                total += base.block_cost(int(heights[k]), w)
        return total
    for l in range(len(Phi)):
        j0, j1 = int(spl[l]), int(spl[l + 1])
        rows = A.idx[A.pos[j0] : A.pos[j1]]
        total += base.stripe_cost(j1 - j0, np.unique(rows).size, rows.size)
    return total


def row_component_value(Pi, model):
    """sum_k alpha_row(u_k) (reference ``row_component_value``)."""
    base = unwrap(model)
    return float(
        sum(component_at(base.alpha_row, int(u)) for u in Pi.widths())
    )


def unwrap(model):
    """Strip :class:`ConstrainedCost` wrappers."""
    while isinstance(model, ConstrainedCost):
        model = model.model
    return model


def constraint_cap(model, default=None):
    """Extract the width cap from a :class:`ConstrainedCost`, if any."""
    if isinstance(model, ConstrainedCost):
        return model.cap
    return default
