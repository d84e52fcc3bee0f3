"""The benchmark's generators against their definitions: the upstream's
synthetic family (d distinct random rows a stripe, every column of a
stripe on them), HPCG's stencil."""

import numpy as np
import pytest
import scipy.sparse as sp

from spbench.gen import blocky, hpcg27


# (12, 2, 8, ...) puts 8 rows a stripe among 24: repeats are drawn again
@pytest.mark.parametrize("L,w,d,seed", [(300, 8, 8, 0), (512, 8, 8, 7),
                                        (100, 6, 8, 2**31 + 5), (12, 2, 8, 3)])
def test_blocky_family(L, w, d, seed):
    A = blocky.generate(seed, L=L, w=w, d=d)
    m = L * w
    assert A.shape == (m, m) and A.dtype == np.float32
    assert A.nnz == L * w * d and np.all(np.diff(A.indptr) == d)
    rows = A.indices.reshape(L, w, d)
    # every column of a stripe on the stripe's rows, sorted and distinct
    assert np.all(rows == rows[:, :1, :])
    assert np.all(np.diff(rows[:, 0, :], axis=1) > 0)
    assert rows.min() >= 0 and rows.max() < m
    assert np.all(A.data != 0)
    again = blocky.generate(seed, L=L, w=w, d=d)
    assert np.array_equal(again.indices, A.indices) and np.array_equal(again.data, A.data)


def test_blocky_rows_spread_over_the_matrix():
    """The rows are uniform over all of it, not banded near the diagonal:
    a stripe's rows lie as far from its columns as chance puts them."""
    L, w, d = 4000, 8, 8
    A = blocky.generate(11, L=L, w=w, d=d)
    rows = A.indices.reshape(L, w, d)[:, 0, :]
    centre = (np.arange(L) * w + w // 2)[:, None]
    dist = np.abs(rows - centre) / (L * w)
    assert 0.30 < dist.mean() < 0.37  # 1/3 for uniform rows
    counts = np.bincount(rows.reshape(-1) * 10 // (L * w), minlength=10)
    assert counts.min() > 0.9 * L * d / 10


@pytest.mark.parametrize("nx,ny,nz", [(3, 3, 3), (8, 8, 8), (5, 4, 6)])
def test_hpcg_stencil(nx, ny, nz):
    A = hpcg27.generate(123, nx=nx, ny=ny, nz=nz)
    n = nx * ny * nz
    assert A.shape == (n, n) and A.dtype == np.float32
    assert A.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert abs(A - A.T).max() == 0
    assert np.all(A.diagonal() == 26)
    # 27 I minus the all-ones 27-point stencil (a Kronecker product of
    # three tridiagonal all-ones matrices, x fastest)
    def ones3(k):
        return sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(k, k))
    J = sp.kron(ones3(nz), sp.kron(ones3(ny), ones3(nx)))
    want = (27 * sp.identity(n) - J).tocsc()
    assert abs(A.astype(np.float64) - want).max() == 0
    B = A.copy()
    B.sum_duplicates()
    B.sort_indices()
    assert np.array_equal(B.indices, A.indices) and np.array_equal(B.indptr, A.indptr)


def test_hpcg_ignores_the_seed():
    a, b = hpcg27.generate(1, 4, 4, 4), hpcg27.generate(2**40, 4, 4, 4)
    assert np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data)
