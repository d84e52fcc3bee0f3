"""The port's 2-D host layer against the JAX package's: bitwise.

The 2-D cost models and ``total_value(..., Pi)``, the DP planner with a
row partition, ``AlternatingPacker`` (the default five-pass min-memory
planner and the reference's strict and overlap planners), ``pack_plaid``,
``pack_vbc2d``, ``to_1d_view`` and ``vbc2d`` of ``vbcs_tpu_torch`` must
return exactly the arrays and numbers ``vbcs_tpu`` returns — with the
shared C++ library and with ``VBCS_NO_NATIVE=1`` (the NumPy oracles).
Bitwise, because both run the same NumPy/C++ arithmetic on the same
inputs: any difference is a porting fault, not rounding.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from corpus import NAMES, load_corpus

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky2d_matrix  # noqa: E402

MATRICES = NAMES + ["blocky2d_k256", "banded_600x900"]


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    vals = rng.standard_normal(n * d).astype(np.float32)
    A = sp.coo_matrix((vals, (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def matrix(name):
    if name == "blocky2d_k256":
        return blocky2d_matrix(K=256, u=4, w=8, d=8, band=40, seed=3)
    if name == "banded_600x900":
        return banded(600, 900, 5, 60, 17)
    return load_corpus()[name].tocsc()


def planners(pkg, U, W, itemsize):
    """The same list of 2-D planners built from either package."""
    mem = pkg.model_vbc_memory(itemsize, 8)
    return [
        pkg.api.default_2d_partitioner(U, W, itemsize),
        pkg.AlternatingPacker(pkg.StrictChunker(W), pkg.StrictChunker(U)),
        pkg.AlternatingPacker(pkg.OverlapChunker(0.7, W),
                              pkg.OverlapChunker(0.7, U)),
        pkg.AlternatingPacker(pkg.EquiChunker(W), pkg.EquiChunker(U)),
        pkg.AlternatePacker(
            pkg.EquiChunker(W), pkg.EquiChunker(U),
            pkg.DynamicTotalChunker(pkg.model_vbc_blocks(), W)),
        pkg.DynamicTotalChunker(pkg.ConstrainedCost(
            mem, pkg.VertexCount(), W)),
    ]


def assert_vbc2d_equal(a, b):
    assert (a.m, a.n, a.U, a.W) == (b.m, b.n, b.U, b.W)
    np.testing.assert_array_equal(a.Pi.spl, b.Pi.spl)
    np.testing.assert_array_equal(a.Phi.spl, b.Phi.spl)
    for f in ("pos", "idx", "ofs", "val"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("VBCS_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("VBCS_NO_NATIVE", raising=False)
    return request.param


@pytest.mark.parametrize("name", MATRICES)
def test_host_layer_2d_bitwise(name, native_mode):
    A = matrix(name)
    Cj, Ct = v.CSC.from_scipy(A), vt.CSC.from_scipy(A)
    item = Cj.val.dtype.itemsize
    for U, W in ((4, 4), (4, 8)):
        for pj, pt in zip(planners(v, U, W, item), planners(vt, U, W, item)):
            Pi_j, Phi_j = v.pack_plaid(Cj, pj)
            Pi_t, Phi_t = vt.pack_plaid(Ct, pt)
            np.testing.assert_array_equal(Pi_j.spl, Pi_t.spl)
            np.testing.assert_array_equal(Phi_j.spl, Phi_t.spl)
            Bj = v.pack_vbc2d(Cj, Pi_j, Phi_j, U, W)
            Bt = vt.pack_vbc2d(Ct, Pi_t, Phi_t, U, W)
            assert_vbc2d_equal(Bj, Bt)
            assert Bj.memory_bytes() == Bt.memory_bytes()
            Vj, Vt = Bj.to_1d_view(), Bt.to_1d_view()
            for f in ("pos", "idx", "ofs", "val"):
                np.testing.assert_array_equal(getattr(Vj, f), getattr(Vt, f))
            for mj, mt in ((v.model_vbc_memory(item, 8),
                            vt.model_vbc_memory(item, 8)),
                           (v.model_vbc_blocks(), vt.model_vbc_blocks())):
                assert v.total_value(Cj, Phi_j, mj, Pi=Pi_j) == vt.total_value(
                    Ct, Phi_t, mt, Pi=Pi_t)
                assert v.row_component_value(Pi_j, mj) == \
                    vt.row_component_value(Pi_t, mt)
        assert_vbc2d_equal(v.vbc2d(A, U, W), vt.vbc2d(A, U, W))


@pytest.mark.parametrize("name", ["LPnetlib/lp_etamacro", "blocky2d_k256",
                                  "banded_600x900"])
def test_dp_with_row_partition_bitwise(name, native_mode):
    """The 2-D DP counts distinct row-blocks of an uneven row partition
    (heights 1..U, and some empty row blocks, which weigh 0)."""
    A = matrix(name)
    Cj, Ct = v.CSC.from_scipy(A), vt.CSC.from_scipy(A)
    rng = np.random.default_rng(5)
    hts = rng.integers(0, 5, A.shape[0])  # 0..4, some empty blocks
    spl = np.concatenate([[0], np.cumsum(hts)])
    spl = spl[spl < A.shape[0]]
    spl = np.concatenate([spl, [A.shape[0]]])
    Pi_j, Pi_t = v.SplitPartition(spl), vt.SplitPartition(spl)
    assert (Pi_t.widths() == 0).any()
    for W in (1, 4, 8):
        models = [
            (v.model_vbc_memory(4, 4), vt.model_vbc_memory(4, 4)),
            (v.model_vbc_blocks(), vt.model_vbc_blocks()),
            (v.BlockComponentCostModel(1.0, 2.0, (v.Line(1, 0.5),),
                                       (v.Line(0.25, 1),)),
             vt.BlockComponentCostModel(1.0, 2.0, (vt.Line(1, 0.5),),
                                        (vt.Line(0.25, 1),))),
        ]
        for mj, mt in models:
            Phi_j = v.DynamicTotalChunker(mj, W).partition(Cj, Pi_j)
            Phi_t = vt.DynamicTotalChunker(mt, W).partition(Ct, Pi_t)
            np.testing.assert_array_equal(Phi_j.spl, Phi_t.spl)
            assert Phi_t.max_width() <= W
            assert v.total_value(Cj, Phi_j, mj, Pi=Pi_j) == vt.total_value(
                Ct, Phi_t, mt, Pi=Pi_t)
            # the trivial row partition is the default
            np.testing.assert_array_equal(
                vt.DynamicTotalChunker(mt, W).partition(Ct).spl,
                v.DynamicTotalChunker(mj, W).partition(Cj).spl)


def test_memory_model_byte_exact_2d():
    """total_value + row_component_value + the four sentinel entries is
    the 2-D format's byte count (as tests/test_planners.py holds for the
    JAX package)."""
    for name in ("LPnetlib/lp_blend", "banded_600x900"):
        A = vt.CSC.from_scipy(matrix(name))
        B = vt.vbc2d(A, 4, 4)
        model = vt.model_vbc_memory(A.val.dtype.itemsize, 8)
        got = (vt.total_value(A, B.Phi, model, Pi=B.Pi)
               + vt.row_component_value(B.Pi, model))
        assert got + 4 * 8 == B.memory_bytes()
        assert vt.total_value(A, B.Phi, vt.model_vbc_blocks(), Pi=B.Pi) == \
            B.num_blocks


def test_oracles_and_view():
    """VBC2D.tr_mul/mul/to_dense against scipy; the 1-D view computes the
    same product."""
    A = matrix("banded_600x900")
    B = vt.vbc2d(A, 3, 5)
    D = A.toarray()
    np.testing.assert_array_equal(B.to_dense(), D)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(600)
    xf = rng.standard_normal(900)
    y0 = rng.standard_normal(900)
    np.testing.assert_allclose(B.tr_mul(x, 2.0, 0.5, y0),
                               2.0 * (D.T @ x) + 0.5 * y0, rtol=1e-12)
    np.testing.assert_allclose(B.mul(xf), D @ xf, rtol=1e-12, atol=1e-12)
    view = B.to_1d_view()
    assert view.val is B.val and view.ofs is B.ofs
    np.testing.assert_allclose(view.tr_mul(x), D.T @ x, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        vt.vbc2d(A, 0, 4)
    with pytest.raises(ValueError):
        vt.vbc2d(A, 4, 0)
