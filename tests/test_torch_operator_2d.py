"""The 2-D operator: the port's ``VBC2DOperator`` against the JAX one.

``vbcs_tpu_torch.VBC2DOperator.from_csc(A, U, W, device="cpu")`` and
``vbcs_tpu.VBC2DOperator.from_csc(A, U, W)`` plan and pack the same f32
matrices: a small ``bench.blocky2d_matrix`` under the JAX bench's equi
plan and under the default five-pass planner, and a random rectangle.
Both must pack the same arrays in both directions, and ``tr_mul``/``mul``
(with alpha, beta and y) must agree with the JAX operator's Pallas route
(interpret mode) and with scipy; ``tr_mul_mat``/``mul_mat`` with the JAX
operator's XLA route (its Pallas SpMM routes on the 1-D view are held
against the port's SpMM kernel in ``test_torch_operator_spmm.py``) and
with scipy.  ``from_host`` takes the JAX package's ``VBC2D``.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX operator and the f64
product — f32 sums in different orders.  Basis vectors are exact.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv as pk1
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import pallas_trspmv2d as pk2d
from vbcs_tpu.ops import pallas_trspmv3 as pk3
from vbcs_tpu.ops import windowed_gather as wg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky2d_matrix  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pk1, pk2, pk2d, pk3, wg):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    yield


def rel_err(got, want):
    return np.abs(got - want).max(initial=0.0) / max(
        1e-6, np.abs(want).max(initial=0.0))


def small_blocky2d():
    return blocky2d_matrix(K=256, u=4, w=8, d=8, band=40, seed=3)


# name -> (matrix, U, W, method pair (JAX, port) or None for the default)
CASES = {
    "blocky2d_equi": lambda: (
        small_blocky2d(), 4, 8,
        (v.AlternatingPacker(v.EquiChunker(8), v.EquiChunker(4)),
         v.AlternatingPacker(v.EquiChunker(4), v.EquiChunker(8))),
        (vt.AlternatingPacker(vt.EquiChunker(8), vt.EquiChunker(4)),
         vt.AlternatingPacker(vt.EquiChunker(4), vt.EquiChunker(8)))),
    "blocky2d_default": lambda: (small_blocky2d(), 4, 8, None, None),
    "random_150x120": lambda: (
        sp.random(150, 120, 0.06, random_state=5, format="csc",
                  dtype=np.float32), 4, 4, None, None),
}


def assert_same_packs(opj, opt):
    for hj, ht in ((opj.host_tr, opt.host_tr), (opj.host_fw, opt.host_fw)):
        assert (hj.U, hj.W) == (ht.U, ht.W)
        np.testing.assert_array_equal(hj.Pi.spl, ht.Pi.spl)
        np.testing.assert_array_equal(hj.Phi.spl, ht.Phi.spl)
        for f in ("pos", "idx", "ofs", "val"):
            np.testing.assert_array_equal(getattr(hj, f), getattr(ht, f))
    assert opt.memory_bytes() == opj.memory_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_2d_matches_jax(case):
    A, U, W, mj, mt = CASES[case]()
    m, n = A.shape
    kw_j = {} if mj is None else dict(method=mj[0], method_forward=mj[1])
    kw_t = {} if mt is None else dict(method=mt[0], method_forward=mt[1])
    opj = v.VBC2DOperator.from_csc(A, U, W, use_pallas=True, **kw_j)
    opt = vt.VBC2DOperator.from_csc(A, U, W, device="cpu", **kw_t)
    assert opt.shape == opj.shape == (m, n)
    assert_same_packs(opj, opt)

    rng = np.random.default_rng(1)
    x_tr = rng.standard_normal(m).astype(np.float32)
    x_fw = rng.standard_normal(n).astype(np.float32)
    y_tr = rng.standard_normal(n).astype(np.float32)
    y_fw = rng.standard_normal(m).astype(np.float32)
    A64 = A.astype(np.float64)
    calls = [
        ("tr_mul", x_tr, 0.5, 0.25, y_tr, 0.5 * (A64.T @ x_tr) + 0.25 * y_tr),
        ("mul", x_fw, -2.0, 1.5, y_fw, -2.0 * (A64 @ x_fw) + 1.5 * y_fw),
    ]
    for fn, x, alpha, beta, y, want in calls:
        yj = np.asarray(getattr(opj, fn)(jnp.asarray(x), alpha, beta,
                                         jnp.asarray(y)))
        yt = getattr(opt, fn)(torch.from_numpy(x), alpha, beta,
                              torch.from_numpy(y)).numpy()
        assert yt.dtype == np.float32 and yt.shape == want.shape
        assert rel_err(yt, yj) <= TOL, fn
        assert rel_err(yt, want) <= TOL, fn

    opx = v.VBC2DOperator(m=m, n=n, host_tr=opj.host_tr, host_fw=opj.host_fw,
                          use_pallas=False)
    X = rng.standard_normal((m, 7)).astype(np.float32)
    Xf = rng.standard_normal((n, 5)).astype(np.float32)
    for fn, Xa, want in (("tr_mul_mat", X, A64.T @ X),
                         ("mul_mat", Xf, A64 @ Xf)):
        Yj = np.asarray(getattr(opx, fn)(jnp.asarray(Xa)))
        Yt = getattr(opt, fn)(torch.from_numpy(Xa)).numpy()
        assert Yt.dtype == np.float32 and Yt.shape == want.shape
        assert rel_err(Yt, Yj) <= TOL, fn
        assert rel_err(Yt, want) <= TOL, fn

    # the SpMM's 1-D views are the host views' arrays, sharing the values
    for host, view, fmt in ((opt.host_tr, opt.view_tr, opt.dev_tr),
                            (opt.host_fw, opt.view_fw, opt.dev_fw)):
        hv = host.to_1d_view()
        np.testing.assert_array_equal(view.pos.numpy(), hv.pos)
        np.testing.assert_array_equal(view.idx.numpy(), hv.idx)
        assert view.val is fmt.val and view.ofs is fmt.ofs


def test_from_host_with_jax_packs():
    A = small_blocky2d().astype(np.float32)
    Bj = v.vbc2d(A, 4, 8, v.AlternatingPacker(v.EquiChunker(8),
                                               v.EquiChunker(4)))
    Bfj = v.vbc2d(A.T.tocsc(), 8, 4)
    op = vt.VBC2DOperator.from_host(Bj, Bfj, "cpu")
    assert op.shape == A.shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    xf = rng.standard_normal(A.shape[1]).astype(np.float32)
    A64 = A.astype(np.float64)
    assert rel_err(op.tr_mul(torch.from_numpy(x)).numpy(), A64.T @ x) <= TOL
    assert rel_err(op.mul(torch.from_numpy(xf)).numpy(), A64 @ xf) <= TOL
    assert rel_err(op.host_tr_mul(x.astype(np.float64)), A64.T @ x) <= 1e-12
    assert rel_err(op.host_mul(xf.astype(np.float64)), A64 @ xf) <= 1e-12

    name, fmt, call = vt.route_tr_spmv_2d(Bj, "cpu")
    assert name == "tile2d" and isinstance(fmt, vt.VBC2DDevice)
    assert call is vt.tr_spmv_2d
    assert rel_err(call(fmt, torch.from_numpy(x)).numpy(), A64.T @ x) <= TOL

    one = vt.VBC2DOperator.from_host(Bj, None, "cpu")
    assert one.shape == A.shape and one.dev_fw is None
    assert rel_err(one.host_mul(xf.astype(np.float64)), A64 @ xf) <= 1e-12
    with pytest.raises(ValueError):
        one.mul(torch.from_numpy(xf))
    with pytest.raises(ValueError):
        one.mul_mat(torch.zeros(A.shape[1], 2))
    fw = vt.VBC2DOperator.from_host(None, Bfj, "cpu")
    assert fw.shape == A.shape
    with pytest.raises(ValueError):
        fw.tr_mul(torch.from_numpy(x))
    with pytest.raises(ValueError):
        fw.tr_mul_mat(torch.zeros(A.shape[0], 2))


def test_basis_vectors_exact():
    A = sp.random(40, 50, 0.2, random_state=9, format="csc", dtype=np.float32)
    op = vt.VBC2DOperator.from_csc(A, 3, 4, device="cpu")
    D = A.toarray()
    for i in range(40):
        e = torch.zeros(40)
        e[i] = 1.0
        np.testing.assert_array_equal(op.tr_mul(e).numpy(), D[i])
    for j in range(50):
        e = torch.zeros(50)
        e[j] = 1.0
        np.testing.assert_array_equal(op.mul(e).numpy(), D[:, j])
    np.testing.assert_array_equal(op.tr_mul_mat(torch.eye(40)).numpy(), D.T)
    np.testing.assert_array_equal(op.mul_mat(torch.eye(50)).numpy(), D)


def test_refusals():
    A = sp.random(30, 20, 0.2, random_state=1, format="csc", dtype=np.float32)
    for U, W in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            vt.VBC2DOperator.from_csc(A, U, W, device="cpu")
    with pytest.raises(ValueError):
        vt.VBC2DOperator.from_csc(A, 4, 4, directions="sideways", device="cpu")
    # f64 packs take the semiring route: no f32 kernel formats, and a
    # bool x is refused there
    for op64 in (vt.VBC2DOperator.from_csc(A.astype(np.float64), 4, 4, device="cpu"),
                 vt.VBC2DOperator.from_host(v.vbc2d(A.astype(np.float64), 4, 4),
                                            None, "cpu")):
        assert op64.dev_tr is None and op64.dev_fw is None
        with pytest.raises(TypeError):
            op64.tr_mul(torch.zeros(30, dtype=torch.bool))
    if not torch.cuda.is_available():  # the default device is the card: no CPU fallback
        with pytest.raises((AssertionError, RuntimeError)):
            vt.VBC2DOperator.from_csc(A, 4, 4)
    with pytest.raises(ValueError):
        vt.VBC2DOperator.from_host(None, None, "cpu")
    B = vt.vbc2d(A, 4, 4)
    with pytest.raises(ValueError):  # host_fw must pack A.T
        vt.VBC2DOperator.from_host(B, B, "cpu")
    op = vt.VBC2DOperator.from_csc(A, 4, 4, directions="transposed",
                                   device="cpu")
    assert op.host_fw is None
    with pytest.raises(ValueError):
        op.mul(torch.zeros(20))
    op = vt.VBC2DOperator.from_csc(A, 4, 4, directions="forward", device="cpu")
    assert op.host_tr is None
    with pytest.raises(ValueError):
        op.tr_mul(torch.zeros(30))
    assert op.mul(torch.zeros(20)).shape == (30,)
    with pytest.raises(ValueError):
        op.mul(torch.zeros(21))
    assert op.mul(torch.zeros(20, dtype=torch.float64)).dtype == torch.float64
    with pytest.raises(TypeError):  # the semiring route refuses a bool x
        op.mul(torch.zeros(20, dtype=torch.bool))
