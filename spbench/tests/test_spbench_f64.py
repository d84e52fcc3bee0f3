"""The float64 cell's limit parts HPCG's own precision from the one
below it: at the small size, the cell's products computed in float32
(the plain reference in float32, and the port's float32 operator with
its operands rounded to float32) read above the limit by more than
1,000x, so a run in the lower precision is not correct; the port in
float64 reads at least 10x under it."""

import time

import numpy as np
import pytest
import torch

from spbench import harness
from spbench.reference import Matrix
from spbench.tests.small import small_cell

CELL = "hpcg_27pt_144_f64.cg_sync"
SEED = 2**33 + 19
SECONDS = 0.3


def _axpby(out, alpha, beta, y):
    if alpha is not None:
        out = out * alpha
    if beta is not None and y is not None:
        out = out + beta * y.to(out.dtype)
    return out


class ReferenceF32:
    """The plain reference in float32 in the port's place (``mul`` and
    ``tr_mul``, the calls of the float64 cell's traffic)."""

    def __init__(self, A, device):
        self.A = Matrix(A, device, dtype=torch.float32)

    def mul(self, x, alpha=None, beta=None, y=None):
        return _axpby(self.A.product(x, transpose=False), alpha, beta, y)

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        return _axpby(self.A.product(x, transpose=True), alpha, beta, y)


class PortF32:
    """The port's operator planned on the matrix in float32, each call
    made on float32 operands."""

    def __init__(self, A, cfg, t, device):
        self.op = harness.program_operator(A.astype(np.float32), cfg, t, device)

    def memory_bytes(self):
        return self.op.memory_bytes()

    def mul(self, x, alpha=None, beta=None, y=None):
        return self.op.mul(x.float(), alpha, beta, None if y is None else y.float())

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        return self.op.tr_mul(x.float(), alpha, beta, None if y is None else y.float())


MAKERS = {
    "reference_f32": lambda A, cfg, t, dev: ReferenceF32(A, dev),
    "port_f32": PortF32,
}


def run(make_operator=harness.program_operator):
    cell = small_cell(CELL)
    result, _ = harness.run_cell(cell, SEED, SECONDS, False, "cpu", time.perf_counter(),
                                 make_operator, log=lambda *a: None)
    return result


def test_the_cell_is_float64():
    cell = small_cell(CELL)
    assert cell.config["args"]["dtype"] == "float64"
    assert "dtype" not in cell.config["reduced"]


def test_port_in_float64_reads_10x_under_the_limit():
    result = run()
    check = result["checks"]["rel_err"]
    assert result["correct"] and result["failed"] == 0, check
    assert check["value"] <= check["limit"] / 10


@pytest.mark.parametrize("side", sorted(MAKERS))
def test_float32_reads_1000x_over_the_limit(side):
    result = run(MAKERS[side])
    check = result["checks"]["rel_err"]
    assert not result["correct"] and result["failed"] >= 1, check
    assert check["value"] >= 1000 * check["limit"]
