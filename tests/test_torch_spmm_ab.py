"""``tools/spmm_ab.py`` on the CPU: its shapes are ``chip_smoke.py``'s, its
bound (``work``, which ``chip_smoke.py`` also uses) counts the bytes and
operations the SpMM needs, it checks the sources it is given, and it
refuses to run without a card (a CPU clock is no device metric)."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.tools import spmm_ab
from vbcs_tpu_torch.tools.matrices import blocky_matrix

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("direction", ["tr", "fw"])
def test_work_is_chip_smokes(direction, k):
    A = blocky_matrix(L=640)
    op = vt.VBCOperator.from_csc(A, W=8, device="cpu")
    fmt = getattr(op, f"nat_{direction}")
    nnz = chip_smoke.nonzeros(A)
    assert chip_smoke.tr_spmm_work is spmm_ab.work  # one bound formula
    index = 4 * (2 * (fmt.L + 1) + fmt.idx.numel())  # int32 spl, pos, idx
    assert spmm_ab.work(fmt, nnz, k) == (4 * nnz + index + 4 * k * (fmt.m + fmt.n),
                                         2 * nnz * k)


def test_shapes_are_chip_smokes():
    """The tool's shapes, by label and k, are the ones phase 8 times."""
    class Op:  # the attributes spmm_shapes reads
        nat_tr = nat_fw = view_tr = view_fw = None
    A = sp.csc_matrix((4, 4), dtype=np.float32)
    X32, X128 = torch.zeros(4, 32), torch.zeros(4, 128)
    runs = {"flagship": (Op, X128, X32), "FEM": (Op, X32, X32),
            "scattered": (Op, X32, None)}
    parts = {p: (A, Op, None, None, None, X128, X32) for p in ("a", "b")}
    got = [(label, X.shape[1]) for label, _, _, _, X in chip_smoke.spmm_shapes(
        (A,), (A,), runs, parts)]
    assert sorted(got) == sorted((label, k) for label, _, _, k in spmm_ab.SHAPES)


def test_library_matrix_is_the_shapes_product():
    """``spmm_ab.csr`` of ``A.T`` (a ``tr_mul_mat`` shape's M) multiplies
    as ``A.T @ X`` does."""
    A = blocky_matrix(L=64).astype(np.float32)
    X = np.random.default_rng(0).standard_normal((A.shape[0], 5)).astype(np.float32)
    got = (spmm_ab.csr(A.T, "cpu") @ torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, A.T @ X, rtol=1e-5, atol=1e-5)


def test_sources_are_checked(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    assert spmm_ab._named([f"k1={src}"], "variant") == [("k1", "variant", str(src))]
    for bad in (str(src), f"k-1={src}", f"k1={tmp_path / 'missing.cu'}"):
        with pytest.raises(SystemExit):
            spmm_ab._named([bad], "variant")


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        spmm_ab.main([])
