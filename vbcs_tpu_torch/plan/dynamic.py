"""Optimal partitioning by dynamic programming — ``DynamicTotalChunker``.

Port of ``vbcs_tpu/plan/dynamic.py`` (NumPy + the shared C++ DP;
bitwise the same split points).  It is the "optimal partitioning" half of
the paper (arXiv:2005.12414) as exposed through ChainPartitioners.jl's
``DynamicTotalChunker(model[, W])``: choose column split points
minimizing the *total* model cost

    sum_stripes  cost(stripe)

subject to stripe width <= W.  The DP is

    opt[j'] = min_{j' - W <= j < j'}  opt[j] + stripe_cost(j, j')

with ``stripe_cost`` needing the number of *distinct rows* (1-D models) or
the rank-R weighted sums of *distinct row-blocks* (2-D separable models)
in columns ``[j, j')``, maintained incrementally with a last-occurrence
counter: when sweeping ``j'`` rightward, ``cnt[c]`` holds the weight of
rows (row-blocks) whose *last* occurrence in ``[0, j')`` is column ``c``;
the distinct weight in ``[j, j')`` is then ``sum(cnt[j:j'])``, a
W-suffix sum.  Total cost: O(nnz + n * W).

Tie-breaking: among equal-cost choices the *narrowest* stripe wins.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csc import CSC
from ..formats.partition import SplitPartition
from ..models.cost import (
    AffineConnectivityModel,
    AffineFillNetCostModel,
    BlockComponentCostModel,
    ColumnBlockComponentCostModel,
    component_table,
    constraint_cap,
    unwrap,
)
from ..native import dp_partition_native

__all__ = ["DynamicTotalChunker", "dp_partition"]


@dataclasses.dataclass(frozen=True)
class DynamicTotalChunker:
    """Optimal DP chunker (reference ``DynamicTotalChunker(model, W)`` /
    ``DynamicTotalChunker(ConstrainedCost(model, VertexCount(), W))``)."""

    model: object
    w_max: int | None = None

    def partition(self, A: CSC, row_partition: SplitPartition | None = None):
        W = constraint_cap(self.model, self.w_max)
        if W is None:
            raise ValueError(
                "DynamicTotalChunker needs a width cap: pass w_max or wrap "
                "the model in ConstrainedCost(model, VertexCount(), W)"
            )
        return dp_partition(A, unwrap(self.model), int(W), row_partition)


def _row_weights(model: BlockComponentCostModel, heights: np.ndarray):
    """``weights[r][k] = beta_row[r](u_k)``, [R, K]; height-0 blocks weigh 0."""
    umax = int(heights.max(initial=1))
    return np.stack(
        [
            np.concatenate([[0.0], component_table(c, umax)])[heights]
            for c in model.beta_row
        ]
    )


def _cost_fn(model, W: int):
    """``cost_fn(widths, counts, nnzs)``: candidate stripe costs,
    vectorized over the width axis (``counts`` has shape [R, len(widths)])."""
    if isinstance(model, ColumnBlockComponentCostModel):
        alpha = model.alpha_table(W)
        beta = model.beta_table(W)

        def cost_fn(widths, counts, nnzs):
            return alpha[widths - 1] + counts[0] * beta[widths - 1]

        return cost_fn

    if isinstance(model, BlockComponentCostModel):
        alpha_col = component_table(model.alpha_col, W)
        beta_col = np.stack([component_table(c, W) for c in model.beta_col])

        def cost_fn(widths, counts, nnzs):
            # counts: [R, nw]; beta_col[:, widths-1]: [R, nw]
            return alpha_col[widths - 1] + np.einsum(
                "rw,rw->w", counts, beta_col[:, widths - 1]
            )

        return cost_fn

    if isinstance(model, AffineConnectivityModel):

        def cost_fn(widths, counts, nnzs):
            return (
                model.alpha
                + model.beta_vertex * widths
                + model.beta_pin * nnzs
                + model.beta_net * counts[0]
            )

        return cost_fn

    if isinstance(model, AffineFillNetCostModel):

        def cost_fn(widths, counts, nnzs):
            return (
                model.alpha
                + model.beta_vertex * widths
                + model.beta_net * counts[0]
                + model.beta_fill * counts[0] * widths
            )

        return cost_fn

    raise TypeError(f"unsupported cost model {type(model).__name__}")


def _native_tables(model, W):
    """(alpha_tab, beta_tabs [R,W], gamma_tab|None) for the C++ DP."""
    ws = np.arange(1, W + 1, dtype=np.float64)
    if isinstance(model, ColumnBlockComponentCostModel):
        return model.alpha_table(W), model.beta_table(W)[None, :], None
    if isinstance(model, BlockComponentCostModel):
        return (
            component_table(model.alpha_col, W),
            np.stack([component_table(c, W) for c in model.beta_col]),
            None,
        )
    if isinstance(model, AffineConnectivityModel):
        return (
            model.alpha + model.beta_vertex * ws,
            np.full((1, W), float(model.beta_net)),
            np.full(W, float(model.beta_pin)),
        )
    # AffineFillNetCostModel (_cost_fn has rejected every other type)
    return (
        model.alpha + model.beta_vertex * ws,
        (model.beta_net + model.beta_fill * ws)[None, :],
        None,
    )


def dp_partition(
    A: CSC,
    model,
    W: int,
    row_partition: SplitPartition | None = None,
) -> SplitPartition:
    """Run the split-point DP; returns the optimal column partition.

    2-D models count distinct row-blocks of ``row_partition`` (default:
    every row its own block).  Uses the C++ implementation when the
    native library loads; the NumPy path below is the bitwise oracle and
    fallback.
    """
    if W < 1:
        raise ValueError(f"width cap W must be >= 1, got {W}")
    n, m = A.n, A.m
    if n == 0:
        return SplitPartition.whole(0)
    pos, idx = A.pos, A.idx
    cost_fn = _cost_fn(model, W)

    is_2d = isinstance(model, BlockComponentCostModel)
    if is_2d:
        Pi = row_partition if row_partition is not None else (
            SplitPartition.trivial(m))
        asg = Pi.to_map().asg
        weights = _row_weights(model, Pi.widths().astype(np.int64))
        num_groups = len(Pi)
        grp = asg[idx]
    else:
        weights = None
        num_groups = m
        grp = idx

    alpha_tab, beta_tabs, gamma_tab = _native_tables(model, W)
    spl = dp_partition_native(
        n, num_groups, pos, grp, W, alpha_tab, beta_tabs, gamma_tab, weights,
    )
    if spl is not None:
        return SplitPartition(spl)

    if weights is None:
        weights = np.ones((1, max(num_groups, 1)))
    R = weights.shape[0]
    lst = np.full(max(num_groups, 1), -1, dtype=np.int64)
    cnt = np.zeros((R, n), dtype=np.float64)

    opt = np.full(n + 1, np.inf)
    opt[0] = 0.0
    prev = np.zeros(n + 1, dtype=np.int64)

    for jp in range(1, n + 1):
        c = jp - 1
        g = idx[pos[c] : pos[c + 1]]
        if is_2d:
            g = np.unique(asg[g])
        if g.size:
            old = lst[g]
            seen = old >= 0
            if np.any(seen):
                np.subtract.at(cnt.T, (old[seen],), weights[:, g[seen]].T)
            cnt[:, c] += weights[:, g].sum(axis=1)
            lst[g] = c
        W_eff = min(W, jp)
        win = cnt[:, jp - W_eff : jp]  # columns jp-W_eff .. jp-1
        counts = np.cumsum(win[:, ::-1], axis=1)  # counts[:, w-1] = window sum
        widths = np.arange(1, W_eff + 1, dtype=np.int64)
        nnzs = (pos[jp] - pos[jp - widths]).astype(np.float64)
        cand = opt[jp - widths] + cost_fn(widths, counts, nnzs)
        t = int(np.argmin(cand))  # first min => narrowest stripe on ties
        opt[jp] = cand[t]
        prev[jp] = jp - int(widths[t])

    # Backtrack split points.
    splits = [n]
    j = n
    while j > 0:
        j = int(prev[j])
        splits.append(j)
    splits.reverse()
    return SplitPartition(np.asarray(splits, dtype=np.int64))
