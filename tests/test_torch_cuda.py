"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerance for the stripe TrSpMV and SpMM: ``|Δ| / max|y| <= 2e-5`` (f32
sums in another order than the plain version's atomic ``index_add_``);
the gather moves values without arithmetic and must be bitwise equal.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from corpus import NAMES, load_corpus

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import blocky_matrix, fem_matrix  # noqa: E402
from chip_smoke import long_stripes  # noqa: E402

TOL = 2e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    vals = rng.standard_normal(n * d).astype(np.float32)
    A = sp.coo_matrix((vals, (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def rel_err(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    return np.abs(got - want).max(initial=0.0) / max(
        1e-6, np.abs(want).max(initial=0.0))


# name -> (matrix, W, chunker)
CASES = {
    "uniform8": lambda: (banded(1024, 1024, 6, 50, 1), 8, vt.EquiChunker(8)),
    "w1": lambda: (banded(300, 300, 3, 30, 4), 1, vt.EquiChunker(1)),
    "multiclass_dp": lambda: (banded(500, 500, 5, 60, 12), 4,
                              vt.DynamicTotalChunker(
                                  vt.model_1dvbc_memory(4, 4), 4)),
    "rectangular": lambda: (banded(600, 900, 5, 60, 17), 8, None),
    "flagship_l2048": lambda: (blocky_matrix(L=2048), 8, None),
}


# the matrices and RHS widths of chip_smoke.py's SpMM checks: k=1 and 5
# take the scalar path, 130 two 128-column tiles
SPMM_CASES = {
    **{f"corpus/{name}": (lambda name=name: (
        load_corpus()[name].tocsc().astype(np.float32), 8, None))
       for name in NAMES},
    "multiclass_dp_w4": CASES["multiclass_dp"],
    "long_multigroup_stripes": lambda: (long_stripes(), 8, vt.EquiChunker(8)),
    "rectangular_600x900": CASES["rectangular"],
    "w16": lambda: (banded(400, 400, 5, 40, 3), 16, vt.EquiChunker(16)),
}


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tr_spmv_kernel_matches_plain(case, with_y, cuda_device):
    A, W, method = CASES[case]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(A.shape[0], device=cuda_device, generator=g)
    y = torch.randn(A.shape[1], device=cuda_device, generator=g)
    args = (0.5, 0.25, y) if with_y else ()
    before = vt.tr_spmv.launches
    got = vt.tr_spmv(fmt, x, *args)
    assert vt.tr_spmv.launches == before + 1
    want = vt.tr_spmv_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert got.shape == (A.shape[1],) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL


def test_tr_spmv_basis_vectors_exact(cuda_device):
    B = vt.vbc1d(banded(256, 256, 4, 20, 9), 8)
    fmt = vt.VBC1DDevice.from_host(B, cuda_device)
    D = torch.from_numpy(B.to_dense().astype(np.float32))
    for i in list(range(0, 256, 37)) + [255]:
        e = torch.zeros(256, device=cuda_device)
        e[i] = 1.0
        assert torch.equal(vt.tr_spmv(fmt, e).cpu(), D[i, :])


@pytest.mark.parametrize("k", [1, 5, 32, 128, 130])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_tr_spmm_kernel_matches_plain(case, k, cuda_device):
    A, W, method = SPMM_CASES[case]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    X = torch.randn(A.shape[0], k, device=cuda_device, generator=g)
    before = vt.tr_spmm.launches
    got = vt.tr_spmm(fmt, X)
    assert vt.tr_spmm.launches == before + 1
    want = vt.tr_spmm_plain(fmt, X)
    torch.cuda.synchronize()
    assert got.shape == (A.shape[1], k) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    oracle = A.T.astype(np.float64) @ X.double().cpu().numpy()
    assert rel_err(got, torch.from_numpy(oracle)) <= TOL


def test_tr_spmm_misaligned_x_takes_scalar_path(cuda_device):
    """k % 4 == 0 but X starts 4 bytes past a 16-byte boundary."""
    A = banded(300, 200, 4, 30, 5)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, 8), cuda_device)
    buf = torch.randn(300 * 32 + 1, device=cuda_device)
    X = buf[1:].view(300, 32)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    assert rel_err(vt.tr_spmm(fmt, X), vt.tr_spmm_plain(fmt, X)) <= TOL


def test_tr_spmm_64bit_offsets(cuda_device):
    """Rows and columns 128-129 at k = 2^24: idx[b]*k and j*k reach 2^31
    (an int32 offset would wrap); every other column is an empty stripe
    whose Y rows must be zero.  X and Y are 8.7 GB each."""
    m = n = 130
    k = 1 << 24
    ends = [0, 1, 128, 129]
    rng = np.random.default_rng(8)
    rows = np.repeat(ends, len(ends))
    cols = np.tile(ends, len(ends))
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(m, n)).tocsc().astype(np.float32)
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, 8), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    X = torch.randn(m, k, device=cuda_device, generator=g)
    got = vt.tr_spmm(fmt, X)
    want = vt.tr_spmm_plain(fmt, X)
    torch.cuda.synchronize()
    # compare row by row: a whole-Y temporary would be another 8.7 GB
    inf = float("inf")
    for j in ends:
        err = float(torch.linalg.vector_norm(got[j] - want[j], inf))
        assert err <= TOL * float(torch.linalg.vector_norm(want[j], inf))
    assert float(torch.linalg.vector_norm(got[2:128], inf)) == 0.0


def test_tr_spmm_basis_columns_exact(cuda_device):
    B = vt.vbc1d(banded(256, 256, 4, 20, 9), 8)
    fmt = vt.VBC1DDevice.from_host(B, cuda_device)
    D = torch.from_numpy(B.to_dense().astype(np.float32))
    X = torch.zeros(256, 9, device=cuda_device)
    for j in range(9):
        X[j * 31, j] = 1.0
    Y = vt.tr_spmm(fmt, X).cpu()
    for j in range(9):
        assert torch.equal(Y[:, j], D[j * 31, :])


@pytest.mark.parametrize("masked", [False, True])
def test_gather_kernel_matches_plain(masked, cuda_device):
    n = 100_000
    g = torch.Generator(device=cuda_device).manual_seed(1)
    src = torch.randn(n, device=cuda_device, generator=g)
    perm = torch.randperm(n, device=cuda_device, generator=g).int()
    mask = (torch.rand(n, device=cuda_device, generator=g) > 0.3
            if masked else None)
    before = vt.gather.launches
    got = vt.gather(src, perm, mask)
    assert vt.gather.launches == before + 1
    assert torch.equal(got, vt.gather_plain(src, perm, mask))


def test_wrappers_refuse_mixed_devices(cuda_device):
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(banded(64, 64, 3, 8, 1), 8),
                                   cuda_device)
    with pytest.raises(ValueError):
        vt.tr_spmv(fmt, torch.zeros(64))  # x on the CPU
    with pytest.raises(ValueError):
        vt.tr_spmm(fmt, torch.zeros(64, 4))
    with pytest.raises(ValueError):
        vt.gather(torch.zeros(4, device=cuda_device),
                  torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("k", [40, 80])
def test_operator_on_card(k, cuda_device):
    A = fem_matrix(k=k).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, device=cuda_device)
    assert (op.row_perm is not None) == (k >= 80)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    y = rng.standard_normal(A.shape[1]).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
    A64 = A.astype(np.float64)
    got = op.tr_mul(xt, 0.5, 0.25, yt)
    want = 0.5 * (A64.T @ x) + 0.25 * y
    assert rel_err(got, torch.from_numpy(want)) <= TOL
    got = op.mul(xt)
    assert rel_err(got, torch.from_numpy(A64 @ x)) <= TOL


@pytest.mark.parametrize("k", [40, 80])
def test_operator_spmm_on_card(k, cuda_device):
    A = fem_matrix(k=k).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, device=cuda_device)
    assert (op.row_perm is not None) == (k >= 80)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((A.shape[0], 32)).astype(np.float32)
    Xt = torch.from_numpy(X).to(cuda_device)
    A64 = A.astype(np.float64)
    assert rel_err(op.tr_mul_mat(Xt), torch.from_numpy(A64.T @ X)) <= TOL
    assert rel_err(op.mul_mat(Xt), torch.from_numpy(A64 @ X)) <= TOL
