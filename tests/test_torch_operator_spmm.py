"""The port's ``VBCOperator.tr_mul_mat``/``mul_mat`` against the JAX one.

``vbcs_tpu_torch.VBCOperator.from_csc(A, W=8, device="cpu")`` and
``vbcs_tpu.VBCOperator.from_csc(A, W=8, ...)`` plan, pack and multiply
the same f32 matrices by the same seeded dense RHS.  With
``use_pallas=True`` (Pallas in interpret mode) small matrices reach each
route the JAX operator takes — ``tr_spmm_pallas4``, ``tr_spmm_pallas3``
and ``tr_spmm_pallas`` with its v1 fallback — and a spy asserts which one
ran; the port has one route for all of them.  With ``use_pallas=False``
(the JAX operator's XLA ``tr_spmm``) a scrambled grid on the auto-RCM
path and two corpus matrices run at sizes interpret mode cannot afford.

Tolerance: ``|Δ| / max|Y| <= 2e-5`` against the JAX operator and the f64
product (f32 sums in different orders).
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from corpus import load_corpus
from test_pallas_spmm4 import blocky
from test_torch_spmm import (TOL, banded, interpret_mode,  # noqa: F401
                             jax_routes, rel_err, rhs, scattered)
from vbcs_tpu.ops import pallas_spmm4 as pm4

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import fem_matrix  # noqa: E402


def operators(A, W=8, use_pallas=True, jax_method=None, torch_method=None,
              **kw):
    """The JAX and the port's operator on ``A``; both must pick the same
    relabeling."""
    opj = v.VBCOperator.from_csc(A, W=W, method=jax_method,
                                 use_pallas=use_pallas, **kw)
    opt = vt.VBCOperator.from_csc(A, W=W, method=torch_method, device="cpu",
                                  **kw)
    assert opt.shape == opj.shape == A.shape
    if opj.row_perm is None:
        assert opt.row_perm is None
    else:
        np.testing.assert_array_equal(opt.row_perm, opj.row_perm)
    return opj, opt


def check_mat(opj, opt, fn, A, k, seed=0):
    """``fn`` ("tr_mul_mat" | "mul_mat") of both operators on one seeded
    RHS, within ``TOL`` of each other and of the f64 product."""
    A64 = A.astype(np.float64)
    X = rhs(A.shape[0] if fn == "tr_mul_mat" else A.shape[1], k, seed)
    want = A64.T @ X if fn == "tr_mul_mat" else A64 @ X
    Yt = getattr(opt, fn)(torch.from_numpy(X)).numpy()
    Yj = np.asarray(getattr(opj, fn)(jnp.asarray(X)))
    assert Yt.dtype == np.float32 and Yt.shape == want.shape
    assert rel_err(Yt, Yj) <= TOL, fn
    assert rel_err(Yt, want) <= TOL, fn


def test_spmm4_route(jax_routes):
    A = blocky(64, 8, 4, 60, seed=1)
    opj, opt = operators(A)
    # the operator's own pack at 8 stripes per chunk (its default, 448,
    # costs minutes in interpret mode; the route is the same)
    assert opj._pallas_spmm4() is not False
    opj._fmt_tr4m = pm4.pack_spmm4(opj.host_tr, sl=8)
    check_mat(opj, opt, "tr_mul_mat", A, 7)
    assert jax_routes == ["tr_spmm_pallas4"]
    # the forward pack has many classes: the XLA route stands in for v2
    opx, _ = operators(A, use_pallas=False)
    check_mat(opx, opt, "mul_mat", A, 7)


def test_spmm3_route(jax_routes):
    A = banded(128, 128, 6, 40, seed=11)
    opj, opt = operators(A, jax_method=v.EquiChunker(8),
                         torch_method=vt.EquiChunker(8))
    assert opj._pallas_spmm4() is False
    check_mat(opj, opt, "tr_mul_mat", A, 3)
    assert jax_routes == ["tr_spmm_pallas3"]
    check_mat(opj, opt, "mul_mat", A, 3)
    assert jax_routes == ["tr_spmm_pallas3", "tr_spmm_pallas"]


def test_v2_route(jax_routes):
    A = banded(128, 128, 3, 30, seed=4)
    opj, opt = operators(
        A, W=2, jax_method=v.DynamicTotalChunker(v.model_1dvbc_memory(2, 4), 2),
        torch_method=vt.DynamicTotalChunker(vt.model_1dvbc_memory(2, 4), 2))
    assert len(opj._pallas_tr().classes) == 2
    check_mat(opj, opt, "tr_mul_mat", A, 3)
    assert jax_routes == ["tr_spmm_pallas"]


def test_v2_fallback_route(jax_routes):
    # A.T's 32 stripes hold rows scattered over 8000: every class of the
    # forward pack breaks the x-window bound and goes to the v1 kernel
    A = scattered(8000, 32, 0.005, seed=7).T.tocsc()
    opj, opt = operators(A, directions="forward")
    assert opj._pallas_fw().fallback is not None
    check_mat(opj, opt, "mul_mat", A, 3)
    assert jax_routes[0] == "tr_spmm_pallas" and "_run_class" in jax_routes


def test_auto_rcm_xla_route():
    A = fem_matrix(k=80).astype(np.float32)
    opj, opt = operators(A, use_pallas=False)
    assert opt.row_perm is not None
    check_mat(opj, opt, "tr_mul_mat", A, 6)
    check_mat(opj, opt, "mul_mat", A, 6, seed=1)


@pytest.mark.parametrize("name", ["HB/west0132", "LPnetlib/lp_etamacro"])
def test_corpus_xla_route(name):
    A = load_corpus()[name].tocsc().astype(np.float32)
    opj, opt = operators(A, use_pallas=False)
    check_mat(opj, opt, "tr_mul_mat", A, 5)
    check_mat(opj, opt, "mul_mat", A, 5, seed=1)


def test_refusals():
    A = fem_matrix(k=40).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, directions="transposed", device="cpu")
    with pytest.raises(ValueError, match="forward"):
        op.mul_mat(torch.zeros(op.n, 2))
    op = vt.VBCOperator.from_csc(A, directions="forward", device="cpu")
    with pytest.raises(ValueError, match="transposed"):
        op.tr_mul_mat(torch.zeros(op.m, 2))
    # a relabeled operator checks X before its row gather
    op = vt.VBCOperator.from_csc(A, reorder="always", device="cpu")
    assert op.row_perm is not None
    for bad in (torch.zeros(op.m + 1, 2), torch.zeros(op.m)):
        with pytest.raises(ValueError):
            op.tr_mul_mat(bad)
    with pytest.raises(TypeError):  # the semiring route refuses a bool X
        op.mul_mat(torch.zeros(op.n, 2, dtype=torch.bool))
    assert op.tr_mul_mat(torch.zeros(op.m, 0)).shape == (op.n, 0)
