"""The port's SpMM (``ops/spmm.py``) against the JAX package's SpMM kernels.

Each case packs one JAX ``VBC1D`` into the JAX kernel's own format and
into the port's ``VBC1DDevice.from_host``, and multiplies the same seeded
numpy ``X`` through both: ``tr_spmm_pallas4`` (v4, k <= 128),
``tr_spmm_pallas3`` (v3 nat pack, one class), ``tr_spmm_pallas`` (v2)
with its v1 fallback ``pallas_trspmv._run_class``, and the v1
``tr_spmv_pallas`` itself — Pallas in interpret mode.  The multi-class v2
cases are in ``test_torch_spmm_v2.py`` (interpret mode makes them slow).
On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card in
``test_torch_cuda.py``.

Tolerance: ``|Δ| / max|Y| <= 2e-5`` against the JAX kernel and the f64
product — f32 sums in different orders (``tests/test_pallas_spmm4.py``
uses the same bound).  On basis columns each output is one stored value
times 1, so Y must equal the dense matrix exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_spmm as pm
from vbcs_tpu.ops import pallas_spmm3 as sm3
from vbcs_tpu.ops import pallas_spmm4 as pm4
from vbcs_tpu.ops import pallas_trspmv as pk1
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import pallas_trspmv3 as pk3
from vbcs_tpu.ops import windowed_gather as wg
from test_pallas_spmm3 import banded as _banded
from test_pallas_spmm4 import blocky

TOL = 2e-5
ROUTES = ("tr_spmm_pallas4", "tr_spmm_pallas3", "tr_spmm_pallas", "_run_class")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pm, sm3, pm4, pk1, pk2, pk3, wg):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    yield


@pytest.fixture
def jax_routes(monkeypatch):
    """Names of the JAX SpMM kernels (and the v1 fallback) that ran."""
    ran = []
    for mod, name in ((pm4, ROUTES[0]), (sm3, ROUTES[1]), (pm, ROUTES[2]),
                      (pk1, ROUTES[3])):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            ran.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return ran


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def banded(m, n, d, band, seed):
    """``tests/test_pallas_spmm3.py:banded`` (d distinct rows per column
    within +-band of the diagonal) in f32."""
    return _banded(m, n, d, band, seed).astype(np.float32)


def scattered(m, n, density, seed):
    """Unstructured f32 matrix whose rows break the v2 x-window bound."""
    return sp.random(m, n, density, random_state=seed, format="csc",
                     dtype=np.float32)


def rhs(rows, k, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(np.float32)


def check_port(B, A, X, Yj):
    """The port's ``tr_spmm`` on ``B`` within ``TOL`` of the JAX result
    ``Yj`` and of the f64 product."""
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    Yt = vt.tr_spmm(fmt, torch.from_numpy(X)).numpy()
    want = A.T.astype(np.float64) @ X.astype(np.float64)
    assert Yt.dtype == np.float32 and Yt.shape == want.shape
    assert rel_err(Yt, np.asarray(Yj)) <= TOL
    assert rel_err(Yt, want) <= TOL
    return Yt


@pytest.mark.parametrize("k", [7, 128])
def test_matches_spmm4(k, jax_routes):
    A = blocky(64, 8, 4, 60, seed=1)
    B = v.vbc1d(A, 8, v.EquiChunker(8))
    fmt4 = pm4.pack_spmm4(B, sl=8)
    assert fmt4 is not None and fmt4.num_chunks >= 2
    X = rhs(A.shape[0], k)
    check_port(B, A, X, pm4.tr_spmm_pallas4(fmt4, jnp.asarray(X)))
    assert jax_routes == ["tr_spmm_pallas4"]


def test_matches_spmm3(jax_routes):
    A = banded(128, 128, 6, 40, seed=11)
    B = v.vbc1d(A, 8, v.EquiChunker(8))
    assert pm4.pack_spmm4(B) is None  # > MAX_NB blocks in a stripe
    fmt3 = pk3.pack_stream3(B, mode="nat")
    assert fmt3 is not None and len(fmt3.ws) == 1
    X = rhs(A.shape[0], 5)
    check_port(B, A, X, sm3.tr_spmm_pallas3(fmt3, jnp.asarray(X)))
    assert jax_routes == ["tr_spmm_pallas3"]


def test_matches_spmm_v1_fallback(jax_routes):
    A = scattered(8000, 32, 0.005, seed=7)
    B = v.vbc1d(A, 8)
    fmt2 = pk2.pack_stream2(B)
    assert fmt2.fallback is not None
    X = rhs(A.shape[0], 5)
    check_port(B, A, X, pm.tr_spmm_pallas(fmt2, jnp.asarray(X)))
    assert jax_routes[0] == "tr_spmm_pallas" and "_run_class" in jax_routes


def test_matches_v1_stripe_kernel(jax_routes):
    """Row 8 directly: ``tr_spmv_pallas`` on a multi-class DP plan against
    the port's ``tr_spmv`` and its ``tr_spmm`` at k=1."""
    A = banded(500, 500, 5, 60, seed=12)
    B = v.vbc1d(A, 4, v.DynamicTotalChunker(v.model_1dvbc_memory(4, 4), 4))
    assert len(set(B.Phi.widths().tolist())) > 1
    x = rhs(A.shape[0], 1)
    yj = np.asarray(pk1.tr_spmv_pallas(pk1.pack_stream(B), jnp.asarray(x[:, 0])))
    assert jax_routes == ["_run_class"] * len(set(B.Phi.widths().tolist()))
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    yt = vt.tr_spmv(fmt, torch.from_numpy(x[:, 0])).numpy()
    assert rel_err(yt, yj) <= TOL
    Yt = check_port(B, A, x, yj[:, None])
    assert rel_err(Yt[:, 0], yt) <= TOL


@pytest.mark.parametrize("method", ["equi8", "dp4"])
def test_basis_columns_exact(method):
    A = banded(256, 256, 4, 20, seed=9)
    chunker = (vt.EquiChunker(8) if method == "equi8" else
               vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4))
    B = vt.vbc1d(A, 8, chunker)
    X = np.zeros((256, 9), np.float32)
    for j in range(9):
        X[j * 31, j] = 1.0
    Y = vt.tr_spmm(vt.VBC1DDevice.from_host(B, "cpu"), torch.from_numpy(X)).numpy()
    D = B.to_dense().astype(np.float32)
    for j in range(9):
        np.testing.assert_array_equal(Y[:, j], D[j * 31, :])


def test_edge_shapes():
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(banded(64, 48, 3, 8, seed=1), 8), "cpu")
    assert vt.tr_spmm(fmt, torch.zeros(64, 0)).shape == (48, 0)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(sp.csc_matrix((0, 4), dtype=np.float32), 8),
                                   "cpu")
    np.testing.assert_array_equal(vt.tr_spmm(fmt, torch.ones(0, 3)).numpy(),
                                  np.zeros((4, 3), np.float32))
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(sp.csc_matrix((5, 0), dtype=np.float32), 8),
                                   "cpu")
    assert vt.tr_spmm(fmt, torch.ones(5, 3)).shape == (0, 3)


def test_refusals():
    B = vt.vbc1d(banded(64, 48, 3, 8, seed=1), 8)
    fmt = vt.VBC1DDevice.from_host(B, "cpu")
    with pytest.raises(TypeError):
        vt.tr_spmm(fmt, np.zeros((64, 2), np.float32))  # not a tensor
    with pytest.raises(TypeError):
        vt.tr_spmm(fmt, torch.zeros(64, 2, dtype=torch.float64))
    for bad in (torch.zeros(64), torch.zeros(63, 2), torch.zeros(64, 2, 1)):
        with pytest.raises(ValueError):
            vt.tr_spmm(fmt, bad)
    with pytest.raises(ValueError):
        vt.tr_spmm(fmt, torch.zeros(2, 64).T)  # not contiguous
    with pytest.raises(ValueError):
        vt.tr_spmm(fmt, torch.zeros(64, 2, device="meta"))  # other device
    meta = vt.VBC1DDevice.from_host(B, "meta")
    with pytest.raises(NotImplementedError):
        vt.tr_spmm(meta, torch.zeros(64, 2, device="meta"))
