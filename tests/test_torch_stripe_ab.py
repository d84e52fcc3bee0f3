"""``tools/stripe_ab.py`` on the CPU: its bound counts the bytes and
operations ``chip_smoke.tr_spmv_work`` counts, it checks the sources it
is given, and it refuses to run without a card (a CPU clock is no device
metric)."""

import os
import sys

import numpy as np
import pytest
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.tools import stripe_ab
from vbcs_tpu_torch.tools.matrices import blocky_matrix

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("L", [640, 2048])
def test_work_is_chip_smokes(L):
    A = blocky_matrix(L=L)
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device="cpu")
    fmt = op.route_tr[1]
    nnz = chip_smoke.nonzeros(A)
    assert stripe_ab.work(fmt, nnz) == chip_smoke.tr_spmv_work(fmt, nnz, True)


def test_sources_are_checked(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    assert stripe_ab._named([f"k1={src}"], "variant") == [("k1", "variant", str(src))]
    for bad in (str(src), f"k-1={src}", f"k1={tmp_path / 'missing.cu'}"):
        with pytest.raises(SystemExit):
            stripe_ab._named([bad], "variant")


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        stripe_ab.main([])
