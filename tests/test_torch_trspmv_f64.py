"""The stripe TrSpMV in float64: ``VBC1DDevice.from_host(..., dtype=
torch.float64)``, the f64 staged map's runs (``ops/trspmv.stage_plan`` at
the f64 stage) and the 1-D operator's f64 ``mul``/``tr_mul``.

On the CPU the operator's f64 calls (the stripe route's plain version)
are held within 1e-12 relative of scipy's f64 product and of the
semiring route, on HPCG's stencil at 11^3 (auto-RCM forced on and off;
the scatter guard admits these packs, but an f64 pack takes the stripe
route) and at 16^3, a corpus matrix and the FEM synthetic.  The cases
marked ``cuda`` run the f64 kernel on a card (a CUDA kernel has no
CPU mode) and skip without one: against ``tr_spmv_plain`` in f64 (1e-14
relative: the kernel sums with fma, the plain version multiplies, then
adds, in the same block order), a stripe longer than an f64 stage and
one wider than a block's 512 columns (the pass path), ``out=`` through
``col_out``, and one ``staged_f64`` launch a call through the operator.
The file imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_trspmv_f64.py
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from corpus import load_corpus
from spbench.gen import hpcg27
from vbcs_tpu_torch.ops import semiring
from vbcs_tpu_torch.ops.scatter import scatter_admits
from vbcs_tpu_torch.ops.trspmv import (STAGE_COLS, STAGE_STRIPES, STAGE_WORDS,
                                       _cut_runs, stage_elements, stage_plan,
                                       thread_map)
from vbcs_tpu_torch.tools.matrices import fem_matrix
from vbcs_tpu_torch.utils import trace

TOL = 1e-12  # the operator against scipy's f64 product and the semiring route
TOL_KERNEL = 1e-14  # the f64 kernel against its plain version


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def stencil(n):
    return hpcg27.generate(None, n, n, n, dtype="float64")


MATRICES = {  # name -> (f64 matrix, reorder)
    "hpcg27_11_rcm_on": lambda: (stencil(11), "always"),
    "hpcg27_11_rcm_off": lambda: (stencil(11), "never"),
    "hpcg27_16_auto": lambda: (stencil(16), "auto"),
    "corpus_can_292": lambda: (load_corpus()["HB/can_292"].astype(np.float64), "auto"),
    "fem_k40": lambda: (fem_matrix(k=40).astype(np.float64), "auto"),
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def f64_operator(request):
    A, reorder = MATRICES[request.param]()
    op = vt.VBCOperator.from_csc(A, W=8, reorder=reorder, device="cpu")
    return request.param, sp.csc_matrix(A), op


@pytest.mark.parametrize("call", ["bare", "alpha_beta_y"])
@pytest.mark.parametrize("which", ["mul", "tr_mul"])
def test_operator_f64_against_scipy_and_semiring(f64_operator, which, call):
    _, A, op = f64_operator
    assert op.dev_tr.val.dtype == op.dev_fw.val.dtype == torch.float64
    rng = np.random.default_rng(3)
    M = A if which == "mul" else A.T.tocsc()
    x = rng.standard_normal(M.shape[1])
    y = rng.standard_normal(M.shape[0])
    args = (0.5, 0.25, torch.from_numpy(y)) if call == "alpha_beta_y" else ()
    got = getattr(op, which)(torch.from_numpy(x), *args)
    assert got.dtype == torch.float64 and got.shape == (M.shape[0],)
    want = M @ x
    if args:
        want = 0.5 * want + 0.25 * y
    assert rel_err(got, want) <= TOL
    semi = semiring.tr_spmv(op.semi_fw if which == "mul" else op.semi_tr,
                            torch.from_numpy(x))
    if args:
        semi = 0.5 * semi + 0.25 * torch.from_numpy(y)
    assert rel_err(got, semi) <= TOL
    # the route: the stripe kernel's f64 map, where the scatter guard
    # admits the pack too (no f64 scatter kernel)
    assert (op.route_fw if which == "mul" else op.route_tr)[0] == "stripe"


def test_f64_calls_count_by_route():
    """An f64 ``mul``/``tr_mul`` is not a semiring call, on a pack the
    scatter guard admits too; a mixed pair, the chain and the SpMM in f64
    are (counted whether the tracer is on or not)."""
    trace.disable()
    op = vt.VBCOperator.from_csc(stencil(16), W=8, reorder="never", device="cpu")
    x = torch.randn(op.n, dtype=torch.float64)
    before = trace.semiring_calls()
    op.mul(x)
    op.tr_mul(x, 2.0, 0.5, x)
    assert trace.semiring_calls() == before
    op.mul(x.float())
    op.tr_mul_chain(x, 2, 0.5)
    op.mul_mat(x[:, None].repeat(1, 3))
    after = trace.semiring_calls()
    assert after.get("float32", 0) == before.get("float32", 0) + 1
    assert after.get("float64", 0) == before.get("float64", 0) + 2
    scat = vt.VBCOperator.from_csc(stencil(11), W=8, reorder="always", device="cpu")
    assert scatter_admits(scat.host_fw) and scat.route_fw[0] == "stripe"
    scat.mul(torch.randn(scat.n, dtype=torch.float64))
    assert trace.semiring_calls() == after


def test_f64_formats():
    A = stencil(11)
    host = vt.vbc1d(A, 8)
    f64 = vt.VBC1DDevice.from_host(host, "cpu", torch.float64)
    f32 = vt.VBC1DDevice.from_host(host, "cpu")
    assert f64.val.dtype == torch.float64 and f32.val.dtype == torch.float32
    assert torch.equal(f64.val.float(), f32.val)
    assert thread_map(f64) == "staged"
    with pytest.raises(ValueError):
        vt.VBC1DDevice.from_host(host, "cpu", torch.int32)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(f64.n).astype(np.int32))
    view = f64.natural_view(perm)
    assert view.val is f64.val and view.stage_plans is f64.stage_plans
    x = torch.randn(f64.m, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        vt.tr_spmv(f64, x.float())
    with pytest.raises(TypeError, match="float64"):
        vt.tr_spmv(f64, x, 1.0, 0.5, torch.zeros(f64.n))
    with pytest.raises(TypeError, match="float32"):
        vt.tr_spmv(f32, x)
    got = vt.tr_spmv(f64, x, 0.5, 0.25, torch.ones(f64.n, dtype=torch.float64))
    want = 0.5 * (sp.csc_matrix(A).T @ x.numpy()) + 0.25
    assert got.dtype == torch.float64 and rel_err(got, want) <= TOL


def test_f64_stage_plan_runs():
    """The f64 map stages half as many elements; its runs keep to that
    bound (greedy, a stripe beyond it a run of its own) and are cached
    beside the f32 runs of the same arrays."""
    assert stage_elements(torch.float32) == STAGE_WORDS
    assert stage_elements(torch.float64) == STAGE_WORDS // 2
    op = vt.VBCOperator.from_csc(stencil(11), W=8, reorder="always", device="cpu")
    f64 = op.nat_fw
    f32 = dataclasses.replace(f64, val=f64.val.float())
    r64, r32 = stage_plan(f64), stage_plan(f32)
    assert stage_plan(f64) is r64 and stage_plan(f32) is r32
    assert torch.equal(r64, _cut_runs(f64.spl.long(), f64.pos.long(), f64.ofs.long(),
                                      STAGE_COLS, STAGE_STRIPES, STAGE_WORDS // 2))
    assert r64.shape[0] > r32.shape[0]
    spl, pos, ofs = (t.numpy().astype(np.int64) for t in (f64.spl, f64.pos, f64.ofs))
    runs = r64[:, 0].numpy().astype(np.int64)
    used = ofs + pos
    for s0, s1 in zip(runs[:-1], runs[1:]):
        assert s1 - s0 == 1 or used[s1] - used[s0] <= STAGE_WORDS // 2
        assert spl[s1] - spl[s0] <= STAGE_COLS or s1 - s0 == 1
        assert s1 == f64.L or used[s1 + 1] - used[s0] > STAGE_WORDS // 2 or (
            spl[s1 + 1] - spl[s0] > STAGE_COLS or s1 + 1 - s0 > STAGE_STRIPES)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(n * d),
                       (rows.reshape(-1), np.repeat(np.arange(n), d))), shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def rows_pack(splits, m, every, seed=3):
    """A pack under the given stripe splits whose every ``every``-th row
    is dense (f64)."""
    D = np.random.default_rng(seed).standard_normal((m, splits[-1]))
    D *= (np.arange(m) % every == 0)[:, None]
    return vt.pack_1dvbc(vt.CSC.from_scipy(sp.csc_matrix(D)),
                         vt.SplitPartition(np.array(splits)), max(np.diff(splits)))


def natural_view(A, direction, device):
    op = vt.VBCOperator.from_csc(A, W=8, directions=direction, reorder="always",
                                 device=device)
    return op.nat_tr if direction == "transposed" else op.nat_fw


# the f64 map's shapes: the f64 cell's kind of pack at a small size (a
# natural view), a stripe longer than an f64 stage (~2,000 blocks of width
# 3: chunks), a stripe wider than a block's 512 columns (passes) and one
# wider than a whole f64 stage; name -> f64 format maker(device)
F64_CASES = {
    "stencil27_11_rcm": lambda d: natural_view(stencil(11), "forward", d),
    "stripe_longer_than_an_f64_stage": lambda d: vt.VBC1DDevice.from_host(
        vt.vbc1d(banded(9000, 12, 2000, 4500, 5), 3, vt.EquiChunker(3)), d,
        torch.float64),
    "stripe_wider_than_a_block": lambda d: vt.VBC1DDevice.from_host(
        rows_pack([0, 3, 1103, 1110], 30, 6), d, torch.float64),
    "stripe_wider_than_an_f64_stage": lambda d: vt.VBC1DDevice.from_host(
        rows_pack([0, 3, 4003, 4010], 30, 6), d, torch.float64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["bare", "alpha_beta_y", "out"])
@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_f64_kernel_against_plain(case, call, cuda_device):
    """The f64 staged map against ``tr_spmv_plain`` in f64, bare, with
    alpha, beta and y, and into a longer ``out=`` buffer through
    ``col_out`` (its other entries kept); one ``staged_f64`` launch a
    call; two launches bitwise."""
    fmt = F64_CASES[case](cuda_device)
    assert fmt.val.dtype == torch.float64 and thread_map(fmt) == "staged"
    runs = stage_plan(fmt)
    assert runs.shape[0] >= 2
    if case.startswith("stripe_"):  # the long path: one stripe beyond a stage
        nblk, widths = torch.diff(fmt.pos), torch.diff(fmt.spl)
        assert int((nblk * (widths + 1)).max()) > stage_elements(torch.float64)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(fmt.m, device=cuda_device, generator=g, dtype=torch.float64)
    if call == "out":
        place = torch.randperm(2 * fmt.n + 1, device=cuda_device, generator=g)[:fmt.n]
        place = place.int() if fmt.col_out is None else place.int()[fmt.col_out.long()]
        fmt = dataclasses.replace(fmt, col_out=place)
        y = torch.randn(2 * fmt.n + 1, device=cuda_device, generator=g, dtype=torch.float64)
    else:
        y = torch.randn(fmt.n, device=cuda_device, generator=g, dtype=torch.float64)
    args = () if call == "bare" else (0.5, 0.25, y)
    before = trace.launches_by_map()
    if call == "out":
        got = vt.tr_spmv(fmt, x, *args, out=torch.full_like(y, 7.0))
        again = vt.tr_spmv(fmt, x, *args, out=torch.full_like(y, 7.0))
        want = vt.tr_spmv_plain(fmt, x, *args, out=torch.full_like(y, 7.0))
    else:
        got, again = vt.tr_spmv(fmt, x, *args), vt.tr_spmv(fmt, x, *args)
        want = vt.tr_spmv_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert trace.launches_by_map() == {**before, "staged_f64": before["staged_f64"] + 2}
    assert got.dtype == torch.float64
    assert torch.isfinite(got).all() and rel_err(got.cpu(), want.cpu()) <= TOL_KERNEL
    assert torch.equal(got, again)
    if call == "out":
        kept = torch.ones(got.numel(), dtype=torch.bool, device=cuda_device)
        kept[fmt.col_out.long()] = False
        assert (got[kept] == 7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mul", "tr_mul"])
def test_f64_operator_runs_the_kernel(which, cuda_device):
    """``from_csc`` of an f64 matrix, then ``mul``/``tr_mul`` with an f64
    x: one ``staged_f64`` launch a call and no semiring call, within 1e-12
    of scipy; an f32 x on the same operator takes the semiring route."""
    A = stencil(16)
    op = vt.VBCOperator.from_csc(A, W=8, reorder="never", device=cuda_device)
    x = torch.randn(op.n, dtype=torch.float64)
    call = getattr(op, which)
    call(x.to(cuda_device))  # the route built
    before, semi = trace.launches_by_map(), trace.semiring_calls()
    for _ in range(3):
        got = call(x.to(cuda_device), 0.5, 0.25, x.to(cuda_device))
    torch.cuda.synchronize()
    assert trace.launches_by_map() == {**before, "staged_f64": before["staged_f64"] + 3}
    assert trace.semiring_calls() == semi
    M = sp.csc_matrix(A) if which == "mul" else sp.csc_matrix(A).T
    want = 0.5 * (M @ x.numpy()) + 0.25 * x.numpy()
    assert rel_err(got.cpu(), want) <= TOL
    mixed = call(x.float().to(cuda_device))
    assert mixed.dtype == torch.float32
    assert trace.semiring_calls().get("float32", 0) == semi.get("float32", 0) + 1
