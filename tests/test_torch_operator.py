"""The slice as a whole: the port's ``VBCOperator`` against the JAX one.

``vbcs_tpu_torch.VBCOperator.from_csc(A, W=8, device="cpu")`` and
``vbcs_tpu.VBCOperator.from_csc(A, W=8, use_pallas=True)`` (Pallas in
interpret mode) plan, pack and multiply the same f32 matrices: the
flagship generator at L=2048, a scrambled k=80 grid Laplacian on which
both take the auto-RCM path, and a k=40 one relabeled with
``reorder="always"`` (the corpus is in ``test_torch_operator_corpus.py``).
Both must pick the same relabeling and pack the same arrays, and their
``tr_mul``/``mul`` (with alpha, beta and y) must agree.  The two
auto-RCM rules differ on other matrices: the port's relabels where RCM
shrinks the packs it holds (``test_torch_auto_rcm.py``), the JAX
operator's by its TPU window estimate.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX operator and the
f64 host oracle — f32 sums in different orders (as
``tests/test_pallas_oneshot3.py:56-57``).
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu_torch.utils import trace
from corpus import load_corpus
from vbcs_tpu.ops import pallas_trspmv3 as pk3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky_matrix, fem_matrix  # noqa: E402

TOL = 2e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(pk3.pl, "pallas_call", patched)
    yield


def matrix(name):
    if name == "fem40":
        return fem_matrix(k=40).astype(np.float32)
    return load_corpus()[name].tocsc().astype(np.float32)


def rel_err(got, want):
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def check_operator(A, reorder="auto"):
    """Both operators on ``A``: same relabeling, same packs, and
    ``tr_mul``/``mul`` with alpha, beta and y within ``TOL`` of each other
    and of the f64 product."""
    m, n = A.shape
    opj = v.VBCOperator.from_csc(A, W=8, use_pallas=True, reorder=reorder)
    opt = vt.VBCOperator.from_csc(A, W=8, reorder=reorder, device="cpu")
    assert opt.shape == opj.shape == (m, n)
    if opj.row_perm is None:
        assert opt.row_perm is None
    else:
        np.testing.assert_array_equal(opt.row_perm, opj.row_perm)
    for hj, ht in ((opj.host_tr, opt.host_tr), (opj.host_fw, opt.host_fw)):
        for f in ("pos", "idx", "ofs", "val"):
            np.testing.assert_array_equal(getattr(hj, f), getattr(ht, f))
    # the port adds the ordered scatter's maps where its forward products
    # run on A's pack (operator.forward_pack)
    maps = opt.ordered_fw.ordered_maps.nbytes if opt.fw_on_a else 0
    assert opt.memory_bytes() == opj.memory_bytes() + maps

    rng = np.random.default_rng(1)
    x_tr = rng.standard_normal(m).astype(np.float32)
    x_fw = rng.standard_normal(n).astype(np.float32)
    y_tr = rng.standard_normal(n).astype(np.float32)
    y_fw = rng.standard_normal(m).astype(np.float32)
    A64 = A.astype(np.float64)
    calls = [
        ("tr_mul", x_tr, 0.5, 0.25, y_tr,
         0.5 * (A64.T @ x_tr) + 0.25 * y_tr),
        ("mul", x_fw, -2.0, 1.5, y_fw, -2.0 * (A64 @ x_fw) + 1.5 * y_fw),
    ]
    for fn, x, alpha, beta, y, want in calls:
        yj = np.asarray(getattr(opj, fn)(
            jnp.asarray(x), alpha, beta, jnp.asarray(y)))
        yt = getattr(opt, fn)(
            torch.from_numpy(x), alpha, beta, torch.from_numpy(y)).numpy()
        assert yt.dtype == np.float32 and yt.shape == want.shape
        assert rel_err(yt, yj) <= TOL, fn
        assert rel_err(yt, want) <= TOL, fn
    return opt


def test_flagship_shape_matches_jax():
    op = check_operator(blocky_matrix(L=2048, w=8, d=8, band=300, seed=21))
    assert op.row_perm is None
    x = np.random.default_rng(4).standard_normal(op.m).astype(np.float32)
    # alpha/beta defaults: the bare product, as the host oracle gives it
    assert rel_err(op.tr_mul(torch.from_numpy(x)).numpy(),
                   op.host_tr_mul(x.astype(np.float64))) <= TOL


def test_auto_rcm_matches_jax():
    # window_badness is 0 below 7 aligned 1024-row windows, so the
    # scrambled grid needs k >= 80 (6400 rows) for the JAX operator's
    # auto-RCM to trigger (the port's bytes rule relabels it at k = 40 too)
    op = check_operator(fem_matrix(k=80).astype(np.float32))
    assert op.row_perm is not None and op.perm_t.dtype == torch.int32


@pytest.mark.parametrize("k", [40, 64, 80, 100])
def test_auto_rcm_decision_matches_jax(k):
    """The port relabels where RCM shrinks the pack it holds, which on the
    scrambled grids is every k (about 15.2 against 16.8 bytes a nonzero);
    the JAX operator's TPU window estimate relabels from k = 80 only.
    Where both relabel, they take the same permutation."""
    A = fem_matrix(k=k).astype(np.float32)
    pj = v.VBCOperator.from_csc(A, W=8, use_pallas=True,
                                directions="transposed").row_perm
    pt = vt.VBCOperator.from_csc(A, W=8, directions="transposed",
                                 device="cpu").row_perm
    C = vt.CSC.from_scipy(A)
    Cp, perm = vt.rcm_symmetric(C)
    assert vt.vbc1d(Cp, 8).memory_bytes() < vt.vbc1d(C, 8).memory_bytes()
    assert pt is not None and (pj is None) == (k < 80)
    np.testing.assert_array_equal(pt, perm)
    if pj is not None:
        np.testing.assert_array_equal(pj, pt)


def test_reorder_always_small_grid():
    op = check_operator(fem_matrix(k=40).astype(np.float32), reorder="always")
    assert op.row_perm is not None


def test_route_and_from_host():
    A = matrix("HB/can_292")
    x = np.random.default_rng(2).standard_normal(A.shape[0]).astype(np.float32)
    # the default plan (mean stripe width 1.97, within the guard's 2.0),
    # 8-wide stripes, and an unblocked (width-1) plan of the same matrix
    for method, want in ((None, "scatter"), (v.EquiChunker(8), "stripe"),
                         (v.EquiChunker(1), "scatter")):
        Bm = v.vbc1d(A, 8, method)
        width = float(np.diff(Bm.Phi.spl).mean())
        name, fmt, call = vt.route_tr_spmv(Bm, "cpu")
        assert name == want, (method, width)
        assert isinstance(fmt, vt.ScatterDevice) == (want == "scatter")
        assert rel_err(call(fmt, torch.from_numpy(x)).numpy(),
                       A.T.astype(np.float64) @ x) <= TOL
    B = v.vbc1d(A, 8)
    op = vt.VBCOperator.from_host(B, None, None, "cpu")
    assert op.shape == A.shape and op.dev_fw is None
    with pytest.raises(ValueError):
        op.mul(torch.from_numpy(x))


def test_refusals():
    A = matrix("HB/can_292")
    # an f64 matrix has f64 kernel formats (the stripe kernel's f64 map);
    # an f64 matrix with an f32 x takes the semiring route in f32; a bool
    # x is refused there, as JAX's segment_sum refuses it
    op64 = vt.VBCOperator.from_csc(A.astype(np.float64), device="cpu")
    assert op64.dev_tr.val.dtype == op64.dev_fw.val.dtype == torch.float64
    before = trace.semiring_calls().get("float32", 0)
    x32 = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0])).float()
    got = op64.tr_mul(x32)
    assert got.dtype == torch.float32
    assert trace.semiring_calls()["float32"] == before + 1
    want = A.T.astype(np.float64) @ x32.numpy().astype(np.float64)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(TypeError):
        op64.tr_mul(torch.zeros(A.shape[0], dtype=torch.bool))
    assert op64.route_tr[0] == "stripe"  # an f64 pack: no f64 scatter kernel
    op_int = vt.VBCOperator.from_csc(A.astype(np.int32), device="cpu")
    assert op_int.dev_tr is None and op_int.dev_fw is None
    with pytest.raises(TypeError):
        op_int.route_tr  # no kernel runs an int32 matrix
    if not torch.cuda.is_available():  # the default device is the card: no CPU fallback
        with pytest.raises((AssertionError, RuntimeError)):
            vt.VBCOperator.from_csc(A)
    op = vt.VBCOperator.from_csc(A[:, :200].tocsc(), device="cpu")
    x = torch.zeros(A.shape[0])
    with pytest.raises(ValueError, match="square"):
        op.tr_mul_chain(x, 2)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            vt.VBC2DOperator.from_csc(A, 4, 8)
    op = vt.VBCOperator.from_csc(fem_matrix(k=40).astype(np.float32),
                                 reorder="always", directions="transposed",
                                 device="cpu")
    assert op.row_perm is not None
    with pytest.raises(ValueError):
        op.tr_mul(torch.zeros(op.m + 1))
    # y bypasses the kernel on a relabeled operator: checked all the same
    x = torch.zeros(op.m)
    with pytest.raises(ValueError):
        op.tr_mul(x, 1.0, 0.5, torch.zeros(1))
    with pytest.raises(TypeError):
        op.tr_mul(x, 1.0, 0.5, torch.zeros(op.n, dtype=torch.float64))


def test_import_loads_no_jax():
    code = ("import sys, vbcs_tpu_torch, vbcs_tpu_torch.utils.timing; "
            "assert 'jax' not in sys.modules, 'jax loaded'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_package_sources_never_import_jax():
    banned = re.compile(r"\s*(import|from)\s+(jax|vbcs_tpu)\b")
    pkg = os.path.join(ROOT, "vbcs_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        assert not banned.match(line), (f, line)


def _names_jax_package_path(path) -> bool:
    """Whether a source names a path under ``vbcs_tpu/`` outside its
    comments and docstrings."""
    with open(path) as fh:
        text = fh.read()
    jax_pkg = re.compile(r"(^|[^\w])vbcs_tpu([/\\]|$)")
    if path.endswith(".py"):
        tree = ast.parse(text)
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)}
        return any(isinstance(node, ast.Constant) and isinstance(node.value, str)
                   and id(node) not in docs and jax_pkg.search(node.value)
                   for node in ast.walk(tree))
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    return any(jax_pkg.search(lit) for lit in re.findall(r'"([^"\n]*)"', code))


def test_package_reads_no_file_of_the_jax_package():
    """The port keeps its own copy of what it needs (the C++ host library
    included): no source under ``vbcs_tpu_torch/`` names a path under
    ``vbcs_tpu/`` in its code."""
    pkg = os.path.join(ROOT, "vbcs_tpu_torch")
    sources = [os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files
               if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    assert any(f.endswith("vbc_native.cpp") for f in sources)
    assert [f for f in sources if _names_jax_package_path(f)] == []
    from vbcs_tpu_torch import native

    assert os.path.dirname(native.SRC) == os.path.dirname(native.__file__)
