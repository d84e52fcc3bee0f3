"""The JAX bench's four matrices (``bench.py:148-217`` at the repository
root), kept here so that the port's tools and ``chip_smoke.py`` read no
file of the JAX side: the flagship ``blocky_matrix``, the 2-D
``blocky2d_matrix``, the scrambled FEM ``fem_matrix`` and the
``scattered_matrix`` (``data/scattered.npz``)."""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

__all__ = ["blocky_matrix", "blocky2d_matrix", "fem_matrix", "scattered_matrix",
           "BLOCKY_ABOVE_L2"]

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


# ``blocky_matrix``'s arguments for a TrSpMV whose operands do not fit a
# 50 MB L2: 16x the flagship's stripes (5,120,000 columns, ~40.8M
# nonzeros, ~250 MB a call with y), every other argument at its default
BLOCKY_ABOVE_L2 = dict(L=640_000)


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


def blocky2d_matrix(K=10000, u=4, w=8, d=8, band=400, seed=0):
    """Blocky matrix meant as exact u x w dense tiles (the 2-D kernel's
    row).  As in the JAX bench, ``rows`` run in (tile, column, row) order
    and ``cols`` in (tile, row, column) order, so each tile holds 8 of its
    32 entries at the default u=4, w=8; kept as it is, so both packages
    measure one matrix."""
    rng = np.random.default_rng(seed)
    m, n = K * u, K * w
    rb = np.clip(
        np.arange(K)[:, None] + rng.integers(-band, band, (K, d)), 0, K - 1
    )
    rows = rb.reshape(-1)[:, None] * u + np.arange(u)[None, :]
    rows = np.repeat(rows, w, axis=0).reshape(-1)
    cols = np.repeat(np.arange(K) * w, d)
    cols = (np.repeat(cols, u)[:, None] + np.arange(w)[None, :]).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
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


def scattered_matrix():
    """Information-free scatter (thermal1-sized): ``data/scattered.npz``,
    pre-generated, since ``sp.random`` at this size costs minutes of host
    RNG; generated that way when the file is missing."""
    path = os.path.join(DATA, "scattered.npz")
    if os.path.exists(path):
        return sp.load_npz(path).tocsc()
    return sp.random(82654, 82654, 574458 / 82654**2, random_state=9,
                     format="csc").astype(np.float32)
