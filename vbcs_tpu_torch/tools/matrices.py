"""The method table's two generated matrices, the JAX bench's own
(``bench.py:148-203`` at the repository root), kept here so that the
port's tools need no file outside the package."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["blocky_matrix", "fem_matrix"]


def blocky_matrix(L=40000, w=8, d=8, band=400, seed=0):
    """Banded blocky matrix: L stripes of width w, d blocks per stripe
    with rows within +-band of the diagonal (RCM-ordered-FEM-like;
    mirrors the reference autotuner's synthetic family,
    src/costs.jl:63-82, plus locality)."""
    rng = np.random.default_rng(seed)
    m = L * w
    cs = np.arange(L) * w + w // 2
    rr = np.clip(cs[:, None] + rng.integers(-band, band, (L, d)), 0, m - 1)
    rows = np.repeat(rr.reshape(-1), w)
    cols = (
        np.repeat(np.arange(L) * w, d)[:, None] + np.arange(w)[None, :]
    ).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return A


def fem_matrix(k=320, seed=5):
    """Scrambled 5-point grid Laplacian — thermal1-like FEM structure
    hidden behind a bad row ordering (auto-RCM recovers it)."""
    n = k * k
    main = np.full(n, 4.0)
    off = -np.ones(n - 1)
    offk = -np.ones(n - k)
    A = sp.diags([main, off, off, offk, offk], [0, 1, -1, k, -k],
                 format="csc")
    rng = np.random.default_rng(seed)
    p = rng.permutation(n)
    return A[p][:, p].tocsc()
