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


@pytest.mark.parametrize("label", sorted(stripe_ab.CELLS))
def test_cells_are_the_benchmarks(label):
    """Each TrSpMV cell's matrix is its configuration's in ``spbench``:
    the same generator and arguments, at the configuration's ``small``
    size the same matrix through ``cell_matrix``'s path."""
    import importlib
    import json

    root = os.path.join(os.path.dirname(__file__), "..")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = next(c for c in bench["workloads"] if c["name"] == label)
    with open(os.path.join(root, "spbench", "configs", f"{cell['config']}.json")) as fh:
        cfg = json.load(fh)
    gen, seed, kw, _, _ = stripe_ab.CELLS[label]
    assert gen == cfg["generator"] and {**kw, "dtype": "float32"} == cfg["args"]
    small = importlib.import_module(f"spbench.gen.{gen}").generate(seed, **cfg["small"])
    assert small.shape[0] > 0 and small.nnz > 0


@pytest.mark.parametrize("label", sorted(stripe_ab.F64_CELLS))
def test_f64_cells_are_the_benchmarks(label):
    """The float64 cell's matrix is its configuration's: the same
    generator and arguments, float64 included; at the ``small`` size
    ``cell_matrix``'s generator gives an f64 matrix."""
    import importlib
    import json

    root = os.path.join(os.path.dirname(__file__), "..")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = next(c for c in bench["workloads"] if c["name"] == label)
    with open(os.path.join(root, "spbench", "configs", f"{cell['config']}.json")) as fh:
        cfg = json.load(fh)
    gen, seed, kw, direction, _ = stripe_ab.F64_CELLS[label]
    assert gen == cfg["generator"] and kw == cfg["args"] and kw["dtype"] == "float64"
    assert direction == "forward"  # the cell's mul runs the A.T pack
    small = importlib.import_module(f"spbench.gen.{gen}").generate(
        seed, **{**kw, **cfg["small"]})
    assert small.dtype == np.float64 and small.nnz > 0
