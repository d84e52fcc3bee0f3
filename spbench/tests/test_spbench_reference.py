"""The reference against dense products, and the control's rounding."""

import numpy as np
import pytest
import torch

from spbench.gen import blocky, hpcg27
from spbench.reference import Matrix, round_tf32


@pytest.fixture(params=["blocky", "hpcg"])
def matrix(request):
    if request.param == "blocky":
        return blocky.generate(3, L=40, w=8, d=8)
    return hpcg27.generate(0, 4, 5, 3)


def test_products_match_dense(matrix, monkeypatch):
    monkeypatch.setattr("spbench.reference.BLOCK", 97)  # many blocks
    D = matrix.toarray().astype(np.float64)
    ref = Matrix(matrix, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(D.shape[0], generator=g)
    X = torch.randn(D.shape[1], 5, generator=g)
    np.testing.assert_allclose(ref.product(x, True).numpy(), D.T @ x.double().numpy(),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(ref.product(X, False).numpy(), D @ X.double().numpy(),
                               rtol=1e-13, atol=1e-12)
    want = x.double().numpy()
    for _ in range(4):
        want = 0.25 * (D.T @ want)
    np.testing.assert_allclose(ref.chain(x, 4, 0.25).numpy(), want, rtol=1e-12,
                               atol=1e-12)
    assert ref.product(x, True).dtype == torch.float64


def test_tf32_rounding():
    t = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-11),
                      1 + 2**-10 + 2**-12, 3.0e-30, 0.0], dtype=torch.float32)
    want = [1.0, 1.0, 1 + 4 * 2**-11, -(1 + 4 * 2**-11), 1 + 2**-10,
            float(round_tf32(torch.tensor([3.0e-30]))[0]), 0.0]
    assert round_tf32(t).tolist() == want
    r = round_tf32(torch.randn(10000, generator=torch.Generator().manual_seed(0)))
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)


def test_control_rounds_operands(matrix):
    ref = Matrix(matrix, "cpu", dtype=torch.float32, tf32=True)
    assert torch.all(ref.vals.view(torch.int32) & 0x1FFF == 0)
    assert ref.product(torch.ones(matrix.shape[0]), True).dtype == torch.float32
