"""HPCG's matrix: the 27-point stencil on an nx x ny x nz grid, 26 on the
diagonal and -1 for every other neighbour in the grid (the HPCG
reference, hpcg-benchmark/hpcg ``src/GenerateProblem_ref.cpp``: row
``iz*nx*ny + iy*nx + ix``, neighbours ``sz, sy, sx`` in -1..1 that stay
inside the grid).  Symmetric, so the CSC below is also its CSR.  The
matrix has no random part: the seed is taken and not used."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def generate(seed, nx, ny, nz, dtype="float32"):
    del seed
    n = nx * ny * nz
    iz, iy, ix = np.unravel_index(np.arange(n, dtype=np.int64), (nz, ny, nx))
    # the 27 offsets in lexicographic (sz, sy, sx) order, so each column's
    # rows come out sorted
    offs = np.array([(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1)
                     for sx in (-1, 0, 1)], dtype=np.int64)
    ok = np.ones((n, 27), dtype=bool)
    for k, (sz, sy, sx) in enumerate(offs):
        ok[:, k] = ((iz + sz >= 0) & (iz + sz < nz) & (iy + sy >= 0)
                    & (iy + sy < ny) & (ix + sx >= 0) & (ix + sx < nx))
    delta = offs[:, 0] * nx * ny + offs[:, 1] * nx + offs[:, 2]
    rows = (np.arange(n, dtype=np.int64)[:, None] + delta[None, :])[ok]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=indptr[1:])
    vals = np.where(np.broadcast_to(delta == 0, ok.shape)[ok], 26.0, -1.0)
    A = sp.csc_matrix((vals.astype(dtype), rows.astype(np.int32),
                       indptr.astype(np.int32)), shape=(n, n))
    A.has_sorted_indices = True
    return A
