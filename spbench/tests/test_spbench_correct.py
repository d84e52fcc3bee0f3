"""Whole runs of each cell at a small size, without the harness's look
for a card: the port comes out correct; the control (the reference in
TF32 in its place) and the port broken underneath come out not correct."""

import os
import subprocess
import sys
import time

import pytest

from spbench.tests.small import CELLS, small_cell
from spbench import harness
from spbench.control import ControlOperator

SECONDS = 0.3
SEED = 2**31 + 77


class Broken:
    """The port's operator with one fault planted in what its calls give."""

    def __init__(self, op, fault):
        self.op, self.fault = op, fault

    def memory_bytes(self):
        return self.op.memory_bytes()

    def _spoil(self, out, state):
        if self.fault == "unchanged":
            return state
        if self.fault == "half":  # half the batch left out
            out = out.clone()
            out[:, out.shape[1] // 2:] = 0
            return out
        if self.fault == "altered":  # one answer altered where produced
            out = out.clone()
            flat = out.view(-1)
            flat[flat.numel() // 2] += 1e-3 * flat.abs().max()
            return out
        raise ValueError(self.fault)

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        return self._spoil(self.op.tr_mul(x, alpha, beta, y), x if y is None else y)

    def mul(self, x, alpha=None, beta=None, y=None):
        return self._spoil(self.op.mul(x, alpha, beta, y), x if y is None else y)

    def mul_mat(self, X):
        return self._spoil(self.op.mul_mat(X), X)

    def tr_mul_chain(self, x, n_iters, alpha=None):
        return self._spoil(self.op.tr_mul_chain(x, n_iters, alpha), x)


def run(name, make_operator=harness.program_operator, trace=False):
    cell = small_cell(name, trace)
    result, _ = harness.run_cell(cell, SEED, SECONDS, trace, "cpu", time.perf_counter(),
                                 make_operator, log=lambda *a: None)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result = run(name, lambda A, cfg, t, dev: ControlOperator(A, dev))
    assert not result["correct"], result["checks"]
    check = result["checks"]["rel_err"]
    assert check["value"] > 3 * check["limit"]


FAULTS = [(name, fault) for name in CELLS for fault in ("unchanged", "altered")]
# a batch is the columns of a matrix of vectors: only the SpMM cells have one
FAULTS += [(name, "half") for name in CELLS if "k" in small_cell(name).traffic]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_faults_are_not_correct(name, fault):
    def broken(A, cfg, t, dev):
        return Broken(harness.program_operator(A, cfg, t, dev), fault)

    result = run(name, broken)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


# traffic mixes kept for cells that BENCHMARK.json leaves out for now, each
# on the configuration it was written for (alpha = 1/52 scales the chain
# to the stencil's spectrum)
KEPT = [("hpcg_27pt_144", "chain100")]


@pytest.mark.parametrize("config,mix", KEPT)
def test_kept_mixes_drive_their_configs(config, mix):
    """A mix kept for a later cell still runs whole at the small size and
    comes out correct, so that adding its cell needs only data files."""
    cfg = harness.load_json("configs", config)
    cfg["args"].update(cfg["small"])
    cell = harness.Cell(name=f"{config}.{mix}", chips=1, config=cfg,
                        traffic=harness.load_json("traffic", mix),
                        limits={"rel_err": 1e-5}, metrics=[])
    result, _ = harness.run_cell(cell, SEED, SECONDS, False, "cpu", time.perf_counter(),
                                 log=lambda *a: None)
    assert result["correct"], result["checks"]


def test_run_without_a_card_fails_and_prints_no_result():
    root = os.path.dirname(harness.ROOT)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "spbench.run", "--workload", CELLS[0],
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "CUDA card" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_cells_on_the_card(name, cuda_device):
    cell = small_cell(name, True)
    result, run_ = harness.run_cell(cell, SEED, 1.0, True, cuda_device,
                                    time.perf_counter(), log=lambda *a: None)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
    metrics = harness.read_metrics(cell, run_)
    if "kernel_roofline" in metrics:
        assert 0 < metrics["kernel_roofline"]["value"] <= 105
