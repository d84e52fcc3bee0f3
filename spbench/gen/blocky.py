"""The reference autotuner's TrSpMV synthetics (SparseMatrixVBCs.jl
``src/costs.jl:44-82``): ``L`` stripes of ``w`` columns, each with ``d``
blocks of ``w`` values on ``d`` distinct rows placed at random over all
``m = L * w`` rows (x and y both ``L * w`` long, as the family's working
set ``((3 + d) Ti + 2 w Tu + d w Tv) L`` counts them).  No banding: the
rows of a stripe are uniform over the whole matrix."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _distinct_rows(rng, L, d, m):
    """``[L, d]`` rows, sorted and distinct within each stripe, uniform
    over ``[0, m)``: draw, then draw again the stripes that repeat a row."""
    rows = np.sort(rng.integers(0, m, (L, d)), axis=1)
    while True:
        bad = np.flatnonzero((np.diff(rows, axis=1) == 0).any(axis=1))
        if bad.size == 0:
            return rows
        rows[bad] = np.sort(rng.integers(0, m, (bad.size, d)), axis=1)


def generate(seed, L=640000, w=8, d=8, dtype="float32"):
    rng = np.random.default_rng(seed)
    m = L * w
    rows = _distinct_rows(rng, L, d, m)  # [L, d]
    # stripe j's column c = j*w + k holds one value on each of its d rows
    indices = np.broadcast_to(rows[:, None, :], (L, w, d)).reshape(-1)
    indptr = np.arange(0, L * w * d + 1, d, dtype=np.int64)
    vals = rng.standard_normal(indices.size).astype(dtype)
    A = sp.csc_matrix((vals, indices.astype(np.int32), indptr), shape=(m, m))
    A.has_sorted_indices = True
    return A
