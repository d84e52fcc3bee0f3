"""The port's semiring route (``ops/semiring.py`` on ``SemiringDevice``)
against the JAX package's XLA kernels (``vbcs_tpu/ops/xla.py`` on
``bin_vbc1d``/``bin_vbc2d``) and the JAX operators with
``use_pallas=False``, which run every non-f32 matrix or vector there.

The same host packs (the JAX package's) go through both.  Tolerances:
f64 ``rtol=1e-12`` (sums in another order; x64 is on, as
``tests/conftest.py`` sets it), an f32 result (an f32 x on a bool matrix)
``|Δ| <= 2e-5 max|y|`` (f32 sums in another order), integers and bools
exact, basis vectors bitwise.  Where JAX raises (a bool x, an alpha that
would turn an integer iterate into a float one), the port raises the same
exception type; the port's ``spmv`` also refuses a bool x, where JAX's
scatter-add returns a bool vector.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from corpus import load_corpus
from vbcs_tpu.formats.device import bin_vbc1d, bin_vbc2d
from vbcs_tpu.ops import xla
from vbcs_tpu_torch.ops import semiring

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import fem_matrix  # noqa: E402

CORPUS = load_corpus()
RTOL = 1e-12
F32_TOL = 2e-5


def pack(A, shape):
    """The JAX package's host pack of ``A``: 1-D at W=8 (the min-memory
    plan) or 2-D at U=W=4 (an equi plan: few XLA size classes to compile)."""
    if shape == "1d":
        return v.vbc1d(A, 8)
    return v.vbc2d(A, 4, 4, v.AlternatingPacker(v.EquiChunker(4), v.EquiChunker(4)))


def both(B, dtype=None):
    """The JAX XLA format and the port's flat format of one pack."""
    binf = bin_vbc2d if hasattr(B, "Pi") else bin_vbc1d
    return binf(B, dtype=dtype), vt.SemiringDevice.from_host(B, dtype, device="cpu")


def close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.float32:
        assert np.abs(got - want).max(initial=0.0) <= F32_TOL * max(
            1e-6, np.abs(want).max(initial=0.0))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(initial=1.0))


@jax.jit
def xla_all(dj, x, xf, X, Xf):
    """The four XLA kernels in one compile."""
    return (xla.tr_spmv(dj, x), xla.spmv(dj, xf), xla.tr_spmm(dj, X),
            xla.spmm(dj, Xf))


def check_all(dj, dt, args, exact=False):
    """The port's four functions against ``xla_all`` on the same inputs."""
    want = xla_all(dj, *(jnp.asarray(a) for a in args))
    for fn, a, w in zip((semiring.tr_spmv, semiring.spmv, semiring.tr_spmm,
                         semiring.spmm), args, want):
        close(fn(dt, torch.from_numpy(a)).numpy(), w, exact)


@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_semiring_matches_xla_on_corpus(name, shape):
    A = CORPUS[name].astype(np.float64)
    B = pack(A, shape)
    dj, dt = both(B)
    rng = np.random.default_rng(0)
    m, n = A.shape
    x = rng.standard_normal(m)
    check_all(dj, dt, (x, rng.standard_normal(n), rng.standard_normal((m, 5)),
                       rng.standard_normal((n, 5))))
    close(semiring.tr_spmv(dt, torch.from_numpy(x)).numpy(), B.tr_mul(x))


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_int32_gd99_exact(shape):
    A = CORPUS["Pajek/GD99_c"]  # a bool matrix, run as int32
    B = pack(A, shape)
    dj, dt = both(B, np.int32)
    assert dt.val.dtype == torch.int32
    rng = np.random.default_rng(1)
    m, n = A.shape
    x = rng.integers(-9, 10, m).astype(np.int32)
    check_all(dj, dt, (x, *(rng.integers(-9, 10, s).astype(np.int32)
                            for s in (n, (m, 3), (n, 3)))), exact=True)
    want = A.T.astype(np.int64) @ x
    np.testing.assert_array_equal(
        semiring.tr_spmv(dt, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [2, 5, 16])
@pytest.mark.parametrize("m", [1, 3, 8, 17])
def test_random_grid(m, n):
    """The grid of ``tests/test_device_xla.py``, against the host oracles
    (``VBC1D.tr_mul``/``mul``) that test holds the XLA kernels to."""
    rng = np.random.default_rng(11 + 100 * m + n)
    A = sp.random(m, n, 0.3, random_state=int(rng.integers(2**31)), format="csc")
    B = v.vbc1d(A, 4)
    dt = vt.SemiringDevice.from_host(B, device="cpu")
    x, xf = rng.standard_normal(m), rng.standard_normal(n)
    close(semiring.tr_spmv(dt, torch.from_numpy(x)).numpy(), B.tr_mul(x))
    close(semiring.spmv(dt, torch.from_numpy(xf)).numpy(), B.mul(xf))


@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("k", [1, 5, 32])
def test_spmm(k, shape):
    """SpMM widths against the dense products (the XLA SpMM is held on
    the corpus above, at k=5)."""
    A = CORPUS["LPnetlib/lp_blend"].astype(np.float64)
    dt = vt.SemiringDevice.from_host(pack(A, shape), device="cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((A.shape[0], k))
    Xf = rng.standard_normal((A.shape[1], k))
    close(semiring.tr_spmm(dt, torch.from_numpy(X)).numpy(), A.T @ X)
    close(semiring.spmm(dt, torch.from_numpy(Xf)).numpy(), A @ Xf)


@pytest.mark.parametrize("fn", ["tr_spmv", "spmv", "tr_spmm", "spmm"])
def test_bool_x_raises_in_both(fn):
    A = CORPUS["Pajek/GD99_c"]
    dj, dt = both(v.vbc1d(A, 4))
    shape = (A.shape[0],) if fn.startswith("tr") else (A.shape[1],)
    if fn.endswith("mm"):
        shape += (3,)
    x = np.ones(shape, dtype=bool)
    if fn != "spmv":  # JAX's scatter-add takes a bool x there
        with pytest.raises(TypeError):
            getattr(xla, fn)(dj, jnp.asarray(x))
    with pytest.raises(TypeError):
        getattr(semiring, fn)(dt, torch.from_numpy(x))


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_basis_vectors_exact(shape):
    A = CORPUS["LPnetlib/lpi_itest6"].astype(np.float64)
    _, dt = both(pack(A, shape))
    D = A.toarray()
    m, n = A.shape
    for i in range(m):
        e = np.zeros(m)
        e[i] = 1.0
        assert np.array_equal(semiring.tr_spmv(dt, torch.from_numpy(e)).numpy(), D.T @ e)
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        assert np.array_equal(semiring.spmv(dt, torch.from_numpy(e)).numpy(), D @ e)


def test_format_keeps_the_block_fill():
    """Every stored value of the pack, fill included, in its dtype; the
    coordinates are the f32 format's ``value_coords``."""
    A = CORPUS["HB/west0132"].astype(np.float64)
    B = v.vbc1d(A, 8)
    dt = vt.SemiringDevice.from_host(B, device="cpu")
    assert dt.val.dtype == torch.float64 and dt.val.numel() == B.val.size
    assert dt.val.numel() > A.nnz  # explicit fill
    row, col = vt.VBC1DDevice.from_host(B, "cpu").value_coords
    assert torch.equal(dt.row, row) and torch.equal(dt.col, col)
    assert dt.nbytes == 24 * B.val.size
    assert vt.SemiringDevice.from_host(B, np.int32, device="cpu").val.dtype == torch.int32


# ---- the operators against the JAX operators' XLA route ----------------


def banded(m, n, seed, dtype):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-30, 30, (n, 5)), 0, m - 1)
    A = sp.coo_matrix((rng.integers(-4, 5, n * 5).astype(np.float64),
                       (rows.reshape(-1), np.repeat(np.arange(n), 5))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    A.data[A.data == 0] = 1.0
    if dtype == "bool":
        return (A != 0).tocsc()
    return A.astype(dtype)


def operators(A, shape):
    """(JAX operator with its XLA formats built, port operator on the CPU);
    the formats are built outside ``jax.jit``, which the JAX calls run
    under here (one compile a call, not one an op)."""
    if shape == "1d":
        opj = v.VBCOperator.from_csc(A, W=8, use_pallas=False)
        opt = vt.VBCOperator.from_csc(A, W=8, device="cpu")
    else:  # equi plans: few XLA size classes to compile
        plans = [(pkg.AlternatingPacker(pkg.EquiChunker(8), pkg.EquiChunker(4)),
                  pkg.AlternatingPacker(pkg.EquiChunker(4), pkg.EquiChunker(8)))
                 for pkg in (v, vt)]
        opj = v.VBC2DOperator.from_csc(A, 4, 8, *plans[0], use_pallas=False)
        opt = vt.VBC2DOperator.from_csc(A, 4, 8, *plans[1], device="cpu")
    opj._xla_tr()
    opj._xla_fw()
    return opj, opt


def compare_calls(opj, opt, xdtype, alpha, beta, with_chain):
    """Every call of both operators on the same inputs: equal results
    (f64 to RTOL, integers exactly) of the same dtype, or the same
    exception type."""
    m, n = opt.shape
    rng = np.random.default_rng(7)

    def draw(*shape):
        if np.dtype(xdtype).kind == "f":
            return rng.standard_normal(shape).astype(xdtype)
        return rng.integers(-5, 6, shape).astype(xdtype)

    x, y, xf, yf = draw(m), draw(n), draw(n), draw(m)
    X, Xf = draw(m, 5), draw(n, 5)
    calls = [("tr_mul", (x,)), ("tr_mul", (x, alpha, beta, y)), ("mul", (xf,)),
             ("mul", (xf, alpha, beta, yf)), ("tr_mul_mat", (X,)),
             ("mul_mat", (Xf,))]
    if with_chain:
        calls += [("tr_mul_chain", (x, 3)), ("tr_mul_chain", (x, 2, 0.5))]

    def jax_call(fn, args):
        return getattr(opj, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args))

    runs = []
    for fn, args in calls:
        ta = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args)
        try:  # traced without compiling: does JAX raise here?
            jax.eval_shape(lambda fn=fn, args=args: jax_call(fn, args))
        except TypeError:
            with pytest.raises(TypeError):
                getattr(opt, fn)(*ta)
            continue
        runs.append((fn, args, getattr(opt, fn)(*ta).numpy()))
    # every call that returns, in one compile
    wants = jax.jit(lambda: [jax_call(fn, args) for fn, args, _ in runs])()
    for (_, _, got), want in zip(runs, wants):
        want = np.asarray(want)
        close(got, want, exact=np.dtype(want.dtype).kind in "iub")


@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("mdtype, xdtype", [
    ("float64", np.float64), ("int32", np.int32), ("int32", np.float64),
    ("bool", np.int32), ("bool", np.float32), ("float32", np.float64)])
def test_operators_match_jax_xla(mdtype, xdtype, shape):
    A = banded(300, 240, 5, mdtype)
    opj, opt = operators(A, shape)
    if mdtype == "float64" and shape == "1d":  # the stripe kernel's f64 copies
        assert opt.dev_tr.val.dtype == opt.dev_fw.val.dtype == torch.float64
    elif mdtype != "float32":
        assert opt.dev_tr is None and opt.dev_fw is None  # no kernel formats
    ints = np.dtype(xdtype).kind == "i"
    compare_calls(opj, opt, xdtype, 2 if ints else 0.5, 3 if ints else 0.25,
                  with_chain=False)


@pytest.mark.parametrize("mdtype, xdtype", [
    ("float64", np.float64), ("int32", np.int32), ("bool", np.int32),
    ("float32", np.float64)])
def test_chain_matches_jax_xla(mdtype, xdtype):
    A = banded(260, 260, 6, mdtype)
    opj, opt = operators(A, "1d")
    compare_calls(opj, opt, xdtype, 0.5, 0.25, with_chain=True)


def test_bool_x_raises_in_both_operators():
    A = banded(120, 100, 8, "float64")
    for shape in ("1d", "2d"):
        opj, opt = operators(A, shape)
        x = np.ones(120, dtype=bool)
        with pytest.raises(TypeError):
            opj.tr_mul(jnp.asarray(x))
        with pytest.raises(TypeError):
            opt.tr_mul(torch.from_numpy(x))


def test_auto_rcm_fem_f64_matches_jax():
    """The scrambled k=80 grid as f64: both relabel it by RCM and run the
    semiring route in natural coordinates."""
    A = fem_matrix(k=80).astype(np.float64)
    opj, opt = operators(A, "1d")
    assert opj.row_perm is not None
    np.testing.assert_array_equal(opt.row_perm, opj.row_perm)
    compare_calls(opj, opt, np.float64, 0.5, 0.25, with_chain=True)
