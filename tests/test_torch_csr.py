"""The port's CSC baseline (``ops/csr.py``) against the JAX package's
(``vbcs_tpu/ops/csr.py``): the same flattened arrays (padding entries
carry ``col == n`` and are dropped), and ``csc_tr_spmv``/``csc_spmv`` on
the corpus in f64 within ``rtol=1e-12`` of the JAX functions and the
scipy product (sums in another order; x64 on, as ``tests/conftest.py``
sets it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from corpus import load_corpus
from vbcs_tpu import CSC
from vbcs_tpu.ops import csr

CORPUS = load_corpus()
RTOL = 1e-12


@jax.jit
def jax_both(dev, x, xf):
    return csr.csc_tr_spmv(dev, x), csr.csc_spmv(dev, xf)


def check(A_sp, pad, dtype=np.float64):
    A = CSC.from_scipy(A_sp)
    dj = csr.CSCDevice.from_host(A, dtype, pad)
    dt = vt.CSCDevice.from_host(A, dtype, pad, device="cpu")
    for f in ("col", "rowidx", "val"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)))
    assert dt.val.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert dt.nbytes == 16 * dt.col.numel() + dt.val.numel() * dt.val.element_size()
    rng = np.random.default_rng(4)
    x, xf = rng.standard_normal(A.m), rng.standard_normal(A.n)
    wj = jax_both(dj, jnp.asarray(x), jnp.asarray(xf))
    D = A_sp.toarray().astype(np.float64)
    got = (vt.csc_tr_spmv(dt, torch.from_numpy(x)).numpy(),
           vt.csc_spmv(dt, torch.from_numpy(xf)).numpy())
    for g, w, d in zip(got, wj, (D.T @ x, D @ xf)):
        assert g.dtype == np.float64 and g.shape == d.shape
        for ref in (np.asarray(w), d):
            np.testing.assert_allclose(g, ref, rtol=RTOL,
                                       atol=RTOL * np.abs(d).max(initial=1.0))


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_csc_baseline_matches_jax_on_corpus(name):
    check(CORPUS[name].astype(np.float64), 8)


@pytest.mark.parametrize("pad", [1, 3, 8, 128])
def test_padding(pad):
    """Padded entries (``col == n``, value 0) change nothing, whatever the
    pad; an nnz that is a multiple of the pad gets none."""
    check(CORPUS["HB/west0132"].astype(np.float64), pad)


@pytest.mark.parametrize("pad", [1, 8])
def test_all_zero_matrix(pad):
    check(sp.csc_matrix((5, 7), dtype=np.float64), pad)  # padding entries only


def test_dtypes_follow_x():
    """Values stored as ``dtype`` (default: the matrix's); the product is
    in x's dtype, as the JAX functions compute it; a bool x raises."""
    A = CSC.from_scipy(CORPUS["Pajek/GD99_c"])  # bool
    dt = vt.CSCDevice.from_host(A, device="cpu")
    assert dt.val.dtype == torch.bool
    x = np.arange(A.m, dtype=np.int32)
    got = vt.csc_tr_spmv(dt, torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, CORPUS["Pajek/GD99_c"].T.astype(np.int64) @ x)
    f32 = vt.CSCDevice.from_host(A, np.float32, device="cpu")
    assert f32.val.dtype == torch.float32
    with pytest.raises(TypeError):
        vt.csc_tr_spmv(dt, torch.ones(A.m, dtype=torch.bool))
    with pytest.raises(ValueError):
        vt.csc_tr_spmv(dt, torch.ones(A.m + 1, dtype=torch.int32))
