"""``vbcs_tpu_torch.plan.reorder`` against ``vbcs_tpu.plan.reorder``: the
row reorderings (``rcm_rows``, ``profile_rows``, ``apply_row_perm``) give
the same permutations and CSC arrays, bitwise, on the corpus (square and
rectangular) and on random matrices."""

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu_torch as vt
from corpus import NAMES, load_corpus
from vbcs_tpu.formats.csc import CSC as JCSC
from vbcs_tpu.plan import reorder as jr
from vbcs_tpu_torch.plan import reorder as r

CORPUS = load_corpus()


def assert_same_csc(got, want):
    assert (got.m, got.n) == (want.m, want.n)
    for k in ("pos", "idx", "val"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)


def both(A):
    return vt.CSC.from_scipy(A), JCSC.from_scipy(A)


@pytest.mark.parametrize("fn", ["rcm_rows", "profile_rows"])
@pytest.mark.parametrize("name", NAMES)
def test_corpus_matches_the_jax_package(name, fn):
    A, JA = both(CORPUS[name])
    (B, perm), (JB, jperm) = getattr(r, fn)(A), getattr(jr, fn)(JA)
    assert perm.dtype == jperm.dtype
    np.testing.assert_array_equal(perm, jperm)
    assert_same_csc(B, JB)


@pytest.mark.parametrize("shape", [(60, 60), (40, 90), (90, 40)])
def test_random_matrices_match_the_jax_package(shape):
    for seed in range(3):
        S = sp.random(*shape, 0.06, random_state=seed, format="lil")
        S[shape[0] - 1, 0] = 1.0  # the JAX profile_rows needs a last row
        A, JA = both(S.tocsc())
        for fn in ("rcm_rows", "profile_rows"):
            (B, perm), (JB, jperm) = getattr(r, fn)(A), getattr(jr, fn)(JA)
            np.testing.assert_array_equal(perm, jperm)
            assert_same_csc(B, JB)
        perm = np.random.default_rng(seed).permutation(shape[0])
        assert_same_csc(r.apply_row_perm(A, perm), jr.apply_row_perm(JA, perm))


def test_row_reorders_keep_the_product():
    S = sp.random(70, 50, 0.1, random_state=4, format="csc")
    A = vt.CSC.from_scipy(S)
    x = np.random.default_rng(0).standard_normal(70)
    for fn in (r.rcm_rows, r.profile_rows):
        B, perm = fn(A)
        np.testing.assert_allclose(B.to_scipy().T @ x[perm], S.T @ x, rtol=1e-12)


def test_profile_rows_takes_an_empty_last_row():
    """The JAX package's np.add.reduceat raises when the last row is
    empty; the port sorts it last like any empty row."""
    S = sp.csc_matrix(np.array([[0.0, 2.0], [1.0, 0.0], [0.0, 0.0]]))
    with pytest.raises(IndexError):
        jr.profile_rows(JCSC.from_scipy(S))
    _, perm = r.profile_rows(vt.CSC.from_scipy(S))
    np.testing.assert_array_equal(perm, [1, 0, 2])


def test_exported():
    assert vt.rcm_rows is r.rcm_rows and vt.profile_rows is r.profile_rows
