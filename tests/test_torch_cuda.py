"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerance for the stripe, tile, chain and scatter TrSpMV and the SpMM:
``|Δ| / max|y| <= 2e-5`` (f32 sums in another order than the plain
version's atomic ``index_add_``, and than the f64 oracle); the gather
and the relayout move values without arithmetic and must be bitwise
equal.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from corpus import NAMES, load_corpus
from vbcs_tpu_torch.ops import _lib
from vbcs_tpu_torch.ops.chain import chain_grid, chain_plan
from vbcs_tpu_torch.utils import trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import (blocky2d_matrix, blocky_matrix, fem_matrix,  # noqa: E402
                   scattered_matrix)
from spbench.gen import blocky, hpcg27  # noqa: E402
from chip_smoke import (chain_bytes, chain_oracle,  # noqa: E402
                        chain_residencies, coo_matrix, corrupt_guess,
                        lane_group_packs,
                        launch_chain, long_stripes, mixed_height_pack,
                        mixed_stripes, scatter_packs, straddle_pack,
                        zero_height_pack)

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


def zero_width_pack(splits=(0, 3, 3, 8, 13)):
    """A 1-D pack of 40 rows under ``splits``, a zero-width stripe among
    them, the columns from 8 on with no block (the default: stripes [0,
    3), [3, 3), [3, 8), [8, 13); (0, 8, 8, 12, 20): widths that are
    multiples of 4, four columns a thread)."""
    D = np.zeros((40, splits[-1]), np.float32)
    D[::3, 0:8] = np.random.default_rng(6).standard_normal((14, 8))
    Phi = vt.SplitPartition(np.array(splits))
    return vt.pack_1dvbc(vt.CSC.from_scipy(sp.csc_matrix(D)), Phi, 8)


def empty_stripes_matrix():
    """Uniform width 8, the stripes of columns 16-47 and 88-95 with no
    block."""
    A = banded(300, 128, 12, 60, 21).tolil()
    A[:, 16:48] = 0
    A[:, 88:96] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return A


# the stripe kernel's lane layouts: (block slot, column) for widths up to
# 16, 32-column chunks above; empty, zero-width and long stripes, both
# rectangles; pack -> a host VBC1D
STRIPE_CASES = {
    **{f"width_{w}": (lambda w=w: vt.vbc1d(banded(256, 8 * w, 40, 100, w), w,
                                          vt.EquiChunker(w)))
       for w in (1, 2, 3, 5, 7, 8, 16, 40)},
    "empty_stripes": lambda: vt.vbc1d(empty_stripes_matrix(), 8, vt.EquiChunker(8)),
    "zero_width_stripe": zero_width_pack,
    "zero_width_stripe_in_quads": lambda: zero_width_pack((0, 8, 8, 12, 20)),
    "stripe_of_1600_blocks": lambda: vt.vbc1d(long_stripes(), 8, vt.EquiChunker(8)),
    "tall_900x600": lambda: vt.vbc1d(banded(900, 600, 5, 60, 22), 8),
    "wide_90x700": lambda: vt.vbc1d(banded(90, 700, 4, 20, 23), 8),
}


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_tr_spmv_stripe_layouts(case, with_y, cuda_device):
    """Each layout against the plain version; two launches bitwise."""
    B = STRIPE_CASES[case]()
    fmt = vt.VBC1DDevice.from_host(B, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(B.m, device=cuda_device, generator=g)
    y = torch.randn(B.n, device=cuda_device, generator=g)
    args = (0.5, 0.25, y) if with_y else (None, None, None)
    got, again = vt.tr_spmv(fmt, x, *args), vt.tr_spmv(fmt, x, *args)
    want = vt.tr_spmv_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert got.shape == (B.n,) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("chunker", ["default", "equi8"])
def test_tr_spmv_natural_view_and_out_injection(chunker, cuda_device):
    """``col_out`` as a natural view's permutation, and as an injection of
    two formats' columns into one longer ``out=`` buffer (the overlapped
    halo path's shape): y_in read and y written at the places, the other
    entries kept; on mixed widths (the staged map) and on widths of 8
    (four columns a thread)."""
    from vbcs_tpu_torch.parallel.shard import permute_stripes, stripe_columns

    rng = np.random.default_rng(8)
    A = banded(704, 704, 6, 40, 24)
    B = vt.vbc1d(A, 8, vt.EquiChunker(8) if chunker == "equi8" else None)
    assert vt.VBC1DDevice.from_host(B, "cpu").quad_widths is (chunker == "equi8")
    dev = cuda_device
    perm = torch.from_numpy(rng.permutation(704).astype(np.int32)).to(dev)
    view = vt.VBC1DDevice.from_host(B, dev).natural_view(perm)
    x = torch.from_numpy(rng.standard_normal(704).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(704).astype(np.float32)).to(dev)
    assert rel_err(vt.tr_spmv(view, x, 0.5, 0.25, y),
                   vt.tr_spmv_plain(view, x, 0.5, 0.25, y)) <= TOL
    # stripes split in two formats, each placed at 1 + 2 * column of a
    # buffer of 2 * n + 1 entries
    order = rng.permutation(B.L)
    k = B.L // 3
    buf = torch.full((2 * B.n + 1,), 7.0, device=dev)
    yb = torch.from_numpy(rng.standard_normal(2 * B.n + 1).astype(np.float32)).to(dev)
    for part in (order[:k], order[k:]):
        fmt = vt.VBC1DDevice.from_host(permute_stripes(B, part), dev)
        place = 1 + 2 * stripe_columns(B, part)
        fmt = dataclasses.replace(fmt, col_out=torch.from_numpy(
            place.astype(np.int32)).to(dev))
        assert vt.tr_spmv(fmt, x, 0.5, 0.25, yb, out=buf) is buf
    want = 0.5 * (A.T.astype(np.float64) @ x.double().cpu().numpy())
    want += 0.25 * yb.double().cpu().numpy()[1::2]
    got = buf.cpu()
    assert rel_err(got[1::2], torch.from_numpy(want)) <= TOL
    assert torch.equal(got[0::2], torch.full((B.n + 1,), 7.0))


def test_tr_spmv_cut_at_stripe_boundaries_is_bitwise(cuda_device):
    """A column's sum order is its stripe's own: each rank's slice of a
    pack (the distributed paths' shards), the same slice with its stripes
    reordered, and the whole pack read from a stage (block rows remapped,
    the halo paths' shape) give the whole format's bits."""
    from vbcs_tpu_torch.parallel.shard import permute_stripes, shard_1d, split_ranges

    rng = np.random.default_rng(9)
    A = blocky_matrix(L=1000)
    B = vt.vbc1d(A, 8)
    dev = cuda_device
    x = torch.from_numpy(rng.standard_normal(B.m).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(B.n).astype(np.float32)).to(dev)
    whole = vt.tr_spmv(vt.VBC1DDevice.from_host(B, dev), x, 0.5, 0.25, y)
    ranges = split_ranges(np.diff(np.asarray(B.ofs, dtype=np.int64)), 5)
    spl = np.asarray(B.Phi.spl)
    for rank, (s0, s1) in enumerate(ranges):
        cut = vt.VBC1DDevice.from_host(shard_1d(B, 5, rank, ranges), dev)
        c0, c1 = int(spl[s0]), int(spl[s1])
        assert torch.equal(vt.tr_spmv(cut, x, 0.5, 0.25, y[c0:c1]), whole[c0:c1])
    order = rng.permutation(B.L)
    moved = vt.VBC1DDevice.from_host(permute_stripes(B, order), dev)
    cols = torch.from_numpy(np.concatenate(
        [np.arange(spl[s], spl[s + 1]) for s in order])).to(dev)
    assert torch.equal(vt.tr_spmv(moved, x, 0.5, 0.25, y[cols]), whole[cols])
    stage_of = rng.permutation(B.m)  # row r lies at stage_of[r]
    stage = torch.empty_like(x)
    stage[torch.from_numpy(stage_of).to(dev)] = x
    staged = dataclasses.replace(B, idx=stage_of[np.asarray(B.idx)])
    got = vt.tr_spmv(vt.VBC1DDevice.from_host(staged, dev), stage, 0.5, 0.25, y)
    assert torch.equal(got, whole)


def test_tr_spmv_maps_agree_bitwise(cuda_device):
    """Four columns a thread (widths of 8) and the staged map (the same
    format with ``quad_widths`` off, or its values 4 bytes off a 16-byte
    boundary) add each column's blocks in one order: the same bits; and y
    in and out 4 bytes off a 16-byte boundary (no float4 of y) too."""
    B = vt.vbc1d(blocky_matrix(L=2048), 8)
    dev = cuda_device
    fmt = vt.VBC1DDevice.from_host(B, dev)
    assert fmt.quad_widths
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal(B.m).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(B.n).astype(np.float32)).to(dev)
    want = vt.tr_spmv(fmt, x, 0.5, 0.25, y)
    assert rel_err(want, vt.tr_spmv_plain(fmt, x, 0.5, 0.25, y)) <= TOL
    from vbcs_tpu_torch.ops.trspmv import thread_map

    staged = dataclasses.replace(fmt, quad_widths=False)
    assert thread_map(fmt) == "quad" and thread_map(staged) == "staged"
    assert torch.equal(vt.tr_spmv(staged, x, 0.5, 0.25, y), want)
    shifted = torch.empty(fmt.val.numel() + 1, device=dev)
    shifted[1:] = fmt.val
    assert shifted[1:].data_ptr() % 16 == 4
    off = dataclasses.replace(fmt, val=shifted[1:])
    assert thread_map(off) == "staged"
    assert torch.equal(vt.tr_spmv(off, x, 0.5, 0.25, y), want)
    y_off = torch.empty(B.n + 1, device=dev)
    y_off[1:] = y
    out = torch.full((B.n + 1,), 3.0, device=dev)
    assert vt.tr_spmv(fmt, x, 0.5, 0.25, y_off[1:], out=out[1:]).data_ptr() % 16 == 4
    assert torch.equal(out[1:], want) and out[0].item() == 3.0


def narrow_natural_view(A, direction, device):
    """The natural view of a relabeled pack, as an auto-RCM operator runs
    it (``reorder="always"``: RCM at any size)."""
    op = vt.VBCOperator.from_csc(A, W=8, directions=direction, reorder="always",
                                 device=device)
    return op.nat_tr if direction == "transposed" else op.nat_fw


def mixed_widths_pack(seed=12, n_stripes=300, m=400):
    """Widths 1-7 drawn at random, 6-40 blocks a stripe."""
    rng = np.random.default_rng(seed)
    splits = np.concatenate([[0], np.cumsum(rng.integers(1, 8, n_stripes))])
    n = int(splits[-1])
    w = np.diff(splits)
    rows, cols = [], []
    for s in range(n_stripes):
        r = rng.choice(m, rng.integers(6, 41), replace=False)
        rows.append(np.repeat(r, w[s]))
        cols.append(np.tile(np.arange(splits[s], splits[s + 1]), r.size))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    A = sp.csc_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, n))
    return vt.pack_1dvbc(vt.CSC.from_scipy(A), vt.SplitPartition(splits), 8)


def rows_pack(splits, m, every, seed=3):
    """A pack under the given stripe splits whose every ``every``-th row
    is dense."""
    D = np.random.default_rng(seed).standard_normal((m, splits[-1])).astype(np.float32)
    D *= (np.arange(m) % every == 0)[:, None]
    return vt.pack_1dvbc(vt.CSC.from_scipy(sp.csc_matrix(D)),
                         vt.SplitPartition(np.array(splits)), max(np.diff(splits)))


# the staged map's shapes: the benchmark cells' kinds of pack at small
# sizes (natural views of RCM packs), mixed widths, a stripe longer than a
# stage (~4,000 blocks of width 3: chunks), a stripe wider than a block's
# four passes (five), one both (chunks in passes), one whose block row is
# wider than a whole stage, one stripe; name -> format maker(device)
STAGED_CASES = {
    "blocky_random_rows_rcm": lambda d: narrow_natural_view(
        blocky.generate(2, L=3000), "transposed", d),
    "stencil27_11_rcm": lambda d: narrow_natural_view(
        hpcg27.generate(None, nx=11, ny=11, nz=11), "forward", d),
    "mixed_widths_1_7": lambda d: vt.VBC1DDevice.from_host(mixed_widths_pack(), d),
    "stripe_longer_than_a_stage": lambda d: vt.VBC1DDevice.from_host(
        vt.vbc1d(banded(9000, 12, 4000, 4500, 5), 3, vt.EquiChunker(3)), d),
    "stripe_wider_than_a_block": lambda d: vt.VBC1DDevice.from_host(
        rows_pack([0, 3, 1103, 1110], 30, 6), d),
    "stripe_long_and_wide": lambda d: vt.VBC1DDevice.from_host(
        rows_pack([0, 1501], 30, 3), d),
    "stripe_wider_than_a_stage": lambda d: vt.VBC1DDevice.from_host(
        rows_pack([0, 3, 8003, 8010], 30, 6), d),
    "one_stripe": lambda d: vt.VBC1DDevice.from_host(
        vt.vbc1d(banded(300, 7, 50, 150, 8), 7, vt.EquiChunker(7)), d),
}


@pytest.mark.parametrize("call", ["bare", "alpha_beta_y", "out"])
@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_tr_spmv_staged_map(case, call, cuda_device):
    """The staged map against the plain version, bare, with alpha, beta
    and y, and into a longer ``out=`` buffer through ``col_out`` (its
    other entries kept); one staged launch a call; two launches bitwise."""
    from vbcs_tpu_torch.ops.trspmv import stage_plan

    fmt = STAGED_CASES[case](cuda_device)
    assert not fmt.quad_widths
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(fmt.m, device=cuda_device, generator=g)
    kw = {}
    if call == "out":
        place = torch.randperm(2 * fmt.n + 1, device=cuda_device, generator=g)[:fmt.n]
        place = place.int() if fmt.col_out is None else place.int()[fmt.col_out.long()]
        fmt = dataclasses.replace(fmt, col_out=place)
        y = torch.randn(2 * fmt.n + 1, device=cuda_device, generator=g)
        args = (0.5, 0.25, y)
    else:
        y = torch.randn(fmt.n, device=cuda_device, generator=g)
        args = (0.5, 0.25, y) if call == "alpha_beta_y" else ()
    assert stage_plan(fmt).shape[0] >= 2
    before = trace.launches_by_map()
    if call == "out":
        got = vt.tr_spmv(fmt, x, *args, out=torch.full_like(y, 7.0))
        again = vt.tr_spmv(fmt, x, *args, out=torch.full_like(y, 7.0))
        want = vt.tr_spmv_plain(fmt, x, *args, out=torch.full_like(y, 7.0))
    else:
        got, again = vt.tr_spmv(fmt, x, *args), vt.tr_spmv(fmt, x, *args)
        want = vt.tr_spmv_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert trace.launches_by_map() == {**before, "staged": before["staged"] + 2}
    assert torch.isfinite(got).all() and rel_err(got, want) <= TOL
    assert torch.equal(got, again)
    if call == "out":
        kept = torch.ones(got.numel(), dtype=torch.bool, device=cuda_device)
        kept[fmt.col_out.long()] = False
        assert (got[kept] == 7.0).all()


# sha256 (first 16 hex digits) of the f32 staged map's outputs on each
# STAGED_CASES format, y bare then with alpha 0.5, beta 0.25 and y, x and
# y drawn from default_rng(31) in f32: the bits of the f32-only staged
# kernel, which the kernel templated on its value type must keep (NVIDIA
# H100 80GB HBM3; the sums' order fixes them on any card)
STAGED_F32_DIGESTS = {
    "blocky_random_rows_rcm": "d957a88fb899b120",
    "mixed_widths_1_7": "0b2357c24b75fe5c",
    "one_stripe": "648faace15efacab",
    "stencil27_11_rcm": "6fcf7b128415029a",
    "stripe_long_and_wide": "844780eb404ef83f",
    "stripe_longer_than_a_stage": "097dc227bd0679c1",
    "stripe_wider_than_a_block": "2e44bb6330c14e5f",
    "stripe_wider_than_a_stage": "3ff67e40d621e0dd",
}


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_tr_spmv_staged_f32_bits_kept(case, cuda_device):
    """The f32 staged map gives the f32-only kernel's bits."""
    import hashlib

    fmt = STAGED_CASES[case](cuda_device)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(fmt.m).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.standard_normal(fmt.n).astype(np.float32)).to(cuda_device)
    h = hashlib.sha256()
    for args in ((), (0.5, 0.25, y)):
        h.update(vt.tr_spmv(fmt, x, *args).cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == STAGED_F32_DIGESTS[case]


def test_tr_spmv_launches_by_map(cuda_device):
    """``trace.launches_by_map`` counts an 8-wide pack's launch as
    ``quad`` and a narrow one's as ``staged``."""
    narrow = vt.VBC1DDevice.from_host(mixed_widths_pack(), cuda_device)
    wide = vt.VBC1DDevice.from_host(vt.vbc1d(blocky_matrix(L=2048), 8), cuda_device)
    assert wide.quad_widths and not narrow.quad_widths
    for fmt, key in ((narrow, "staged"), (wide, "quad")):
        before = trace.launches_by_map()
        vt.tr_spmv(fmt, torch.ones(fmt.m, device=cuda_device))
        assert trace.launches_by_map() == {**before, key: before[key] + 1}


def test_operator_auto_keeps_random_row_blocky_on_the_quad_map(cuda_device):
    """Auto-RCM leaves the random-row blocky matrix unrelabeled (RCM would
    cut its 8-wide stripes and grow its pack): the operator's
    ``tr_mul(x, 1, 0.5, y)`` is one launch of the float4 map."""
    A = blocky.generate(2, L=3000)
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device=cuda_device)
    assert op.row_perm is None and op.dev_tr.quad_widths
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(op.m, device=cuda_device, generator=g)
    y = torch.randn(op.n, device=cuda_device, generator=g)
    launches, before = vt.tr_spmv.launches, trace.launches_by_map()
    got = op.tr_mul(x, 1.0, 0.5, y)
    torch.cuda.synchronize()
    assert vt.tr_spmv.launches == launches + 1
    assert trace.launches_by_map() == {**before, "quad": before["quad"] + 1}
    want = vt.tr_spmv_plain(op.dev_tr, x, 1.0, 0.5, y)
    assert torch.isfinite(got).all() and rel_err(got, want) <= TOL
    A64 = A.astype(np.float64)
    want64 = A64.T @ x.cpu().double().numpy() + 0.5 * y.cpu().double().numpy()
    assert rel_err(got, torch.from_numpy(want64)) <= TOL


def test_tr_spmv_staged_cuts_are_bitwise(cuda_device):
    """On the staged map, as on the float4 map, a column's bits are its
    stripe's own: ranks' slices, the stripes reordered, the rows read
    from a remapped stage, and the overlap's two formats written into one
    buffer through ``col_out`` give the whole format's y."""
    from vbcs_tpu_torch.ops import trspmv
    from vbcs_tpu_torch.parallel.shard import (permute_stripes, shard_1d,
                                               split_ranges, stripe_columns)

    rng = np.random.default_rng(11)
    B = mixed_widths_pack(seed=13, n_stripes=600, m=500)
    dev = cuda_device
    x = torch.from_numpy(rng.standard_normal(B.m).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(B.n).astype(np.float32)).to(dev)
    fmt = vt.VBC1DDevice.from_host(B, dev)
    whole = vt.tr_spmv(fmt, x, 0.5, 0.25, y)
    assert trspmv.thread_map(fmt) == "staged"
    ranges = split_ranges(np.diff(np.asarray(B.ofs, dtype=np.int64)), 5)
    spl = np.asarray(B.Phi.spl)
    for rank, (s0, s1) in enumerate(ranges):
        cut = vt.VBC1DDevice.from_host(shard_1d(B, 5, rank, ranges), dev)
        c0, c1 = int(spl[s0]), int(spl[s1])
        assert torch.equal(vt.tr_spmv(cut, x, 0.5, 0.25, y[c0:c1]), whole[c0:c1])
    order = rng.permutation(B.L)
    moved = vt.VBC1DDevice.from_host(permute_stripes(B, order), dev)
    cols = torch.from_numpy(np.concatenate(
        [np.arange(spl[s], spl[s + 1]) for s in order])).to(dev)
    assert torch.equal(vt.tr_spmv(moved, x, 0.5, 0.25, y[cols]), whole[cols])
    stage_of = rng.permutation(B.m)
    stage = torch.empty_like(x)
    stage[torch.from_numpy(stage_of).to(dev)] = x
    staged = dataclasses.replace(B, idx=stage_of[np.asarray(B.idx)])
    got = vt.tr_spmv(vt.VBC1DDevice.from_host(staged, dev), stage, 0.5, 0.25, y)
    assert torch.equal(got, whole)
    out = torch.full_like(y, 7.0)
    k = B.L // 3
    for part in (order[:k], order[k:]):
        f = vt.VBC1DDevice.from_host(permute_stripes(B, part), dev)
        f = dataclasses.replace(f, col_out=torch.from_numpy(
            stripe_columns(B, part).astype(np.int32)).to(dev))
        vt.tr_spmv(f, x, 0.5, 0.25, y, out=out)
    assert torch.equal(out, whole)


@pytest.mark.parametrize("W", [3, 40])
def test_tr_spmv_basis_vectors_exact_other_layouts(W, cuda_device):
    """Exact on basis vectors where a column's blocks spread over slots
    (w = 3: 8 slots a step) and over 32-column chunks (w = 40)."""
    B = vt.vbc1d(banded(200, 8 * W, 4, 20, W), W, vt.EquiChunker(W))
    fmt = vt.VBC1DDevice.from_host(B, cuda_device)
    D = torch.from_numpy(B.to_dense().astype(np.float32))
    for i in list(range(0, 200, 23)) + [199]:
        e = torch.zeros(200, device=cuda_device)
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


SPMM_KS = (1, 3, 4, 5, 31, 32, 33, 128, 130)


def spmm_long_matrix(w, n=None, seed=8):
    """330 x n (8 stripes of width w by default), the first two stripes
    dense over 330 and 300 rows: more than SPMM_LONG_BLOCKS blocks each."""
    A = banded(330, n or 8 * w, 4, 20, seed).tolil()
    rng = np.random.default_rng(seed)
    A[:, :w] = rng.standard_normal((330, w)).astype(np.float32)
    A[30:, w:2 * w] = rng.standard_normal((300, w)).astype(np.float32)
    A = A.tocsc()
    A.eliminate_zeros()
    return A


SPMM_WALKS = {
    **{f"width_{w}": (lambda w=w: vt.vbc1d(banded(90, 3 * w, 30, 40, w), w,
                                          vt.EquiChunker(w))) for w in (1, 2, 3, 5, 8, 16, 40)},
    "long_w3": lambda: vt.vbc1d(spmm_long_matrix(3), 3, vt.EquiChunker(3)),
    "long_w8": lambda: vt.vbc1d(spmm_long_matrix(8), 8, vt.EquiChunker(8)),
    "empty_stripes": lambda: vt.vbc1d(empty_stripes_matrix(), 8, vt.EquiChunker(8)),
    "natural_view": lambda: vt.vbc1d(spmm_long_matrix(3, n=330), 3, vt.EquiChunker(3)),
}


def launch_spmm(fmt, X, width, blocks, longs=True):
    """The SpMM launcher with an explicit width class, block count (the
    launcher pipes class 8 from a mean of 16 blocks a stripe) and long
    stripes (or none: the lanes take every stripe)."""
    ls = fmt.long_stripes if longs else None
    Y = torch.empty(fmt.n, X.shape[1], device=X.device)
    rc = _lib.load().vbcs_tr_spmm(
        fmt.L, X.shape[1], width, int(fmt.quad_widths), blocks,
        vt.formats.device.SPMM_LONG_BLOCKS,
        0 if ls is None else ls.numel(), None if ls is None else ls.data_ptr(),
        fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.idx.data_ptr(), fmt.ofs.data_ptr(),
        None if fmt.col_out is None else fmt.col_out.data_ptr(), fmt.val.data_ptr(),
        X.data_ptr(), Y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return Y


@pytest.mark.parametrize("k", SPMM_KS)
@pytest.mark.parametrize("case", sorted(SPMM_WALKS))
def test_tr_spmm_walks_agree_bitwise(case, k, cuda_device):
    """Every width class, the piped and two-trip walks, the long path on or
    off, the float4 and scalar paths (an X 4 bytes off 16) and two
    launches give one Y, bit for bit (each output's blocks in order with
    fmaf: the slice-2 kernel's order), within TOL of the plain version."""
    fmt = vt.VBC1DDevice.from_host(SPMM_WALKS[case](), cuda_device)
    if case == "natural_view":
        g = torch.Generator().manual_seed(3)
        fmt = fmt.natural_view(torch.randperm(fmt.n, generator=g).int().to(cuda_device))
    assert fmt.long_stripes.numel() == (2 if case.startswith(("long", "natural")) else 0)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    X = torch.randn(fmt.m, k, device=cuda_device, generator=g)
    before = vt.tr_spmm.launches
    want = vt.tr_spmm(fmt, X)
    assert vt.tr_spmm.launches == before + 1
    assert rel_err(want, vt.tr_spmm_plain(fmt, X)) <= TOL
    assert torch.equal(vt.tr_spmm(fmt, X), want)
    for width in (1, 2, 4, 8):
        for blocks in (0, 16 * fmt.L):
            assert torch.equal(launch_spmm(fmt, X, width, blocks), want), (width, blocks)
    assert torch.equal(launch_spmm(fmt, X, fmt.width_class, fmt.idx.numel(), False), want)
    buf = torch.empty(fmt.m * k + 1, device=cuda_device)
    Xu = buf[1:].view(fmt.m, k)
    Xu.copy_(X)
    assert Xu.data_ptr() % 16 != 0
    assert torch.equal(vt.tr_spmm(fmt, Xu), want)


def test_dist_tr_spmm_bitwise_on_card(cuda_device):
    """``dist_tr_spmm`` in two gloo ranks sharing the card, on a pack with
    long stripes and on the narrow A.T pack of a blocky matrix: one SpMM
    launch a rank, Y bitwise the single device's."""
    from vbcs_tpu_torch import entry
    from vbcs_tpu_torch.parallel import comm

    rng = np.random.default_rng(5)
    packs = [vt.vbc1d(spmm_long_matrix(4, n=330), 4, vt.EquiChunker(4)),
             vt.vbc1d(blocky_matrix(L=2048, band=400).T.tocsc(), 8)]
    jobs = [{"path": "tr_spmm", "B": B,
             "x": rng.standard_normal((B.m, 32)).astype(np.float32)} for B in packs]
    ranks = comm.run_ranks(entry.rank_paths, 2, "gloo", "cuda:0", jobs)
    for rank in ranks:
        for rec in rank:
            if rec["stats"]["columns"]:
                assert rec["launches"] == {"tr_spmm": 1}, rec
    for job, rec in zip(jobs, ranks[0]):
        fmt = vt.VBC1DDevice.from_host(job["B"], cuda_device)
        want = vt.tr_spmm(fmt, torch.from_numpy(job["x"]).to(cuda_device)).cpu().numpy()
        np.testing.assert_array_equal(rec["y"], want)


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


@pytest.mark.parametrize("n_tiles", [1, 7, 48, 300])
def test_gather_tiles_kernel_matches_plain(n_tiles, cuda_device):
    """The tile copy against its plain version, bitwise: random tiles of a
    64-tile source, repeats and tile 0 (the halo's padding) among them."""
    g = torch.Generator(device=cuda_device).manual_seed(n_tiles)
    src = torch.randn(64 * 1024, device=cuda_device, generator=g)
    tiles = torch.randint(0, 64, (n_tiles,), device=cuda_device, generator=g,
                          dtype=torch.int32)
    tiles[::3] = 0
    before = vt.gather_tiles.launches
    got = vt.gather_tiles(src, tiles)
    assert vt.gather_tiles.launches == before + 1
    assert torch.equal(got, vt.gather_tiles_plain(src, tiles))
    assert torch.equal(got, vt.gather(src, (tiles.long()[:, None] * 1024 + torch.arange(
        1024, device=cuda_device)).reshape(-1).int()))
    with pytest.raises(ValueError, match="16 bytes"):
        vt.gather_tiles(torch.zeros(3 * 1024 + 1, device=cuda_device)[1:], tiles[:1])


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
    assert op.row_perm is not None  # RCM shrinks the grids' packs at every k
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
    assert op.row_perm is not None  # RCM shrinks the grids' packs at every k
    rng = np.random.default_rng(4)
    X = rng.standard_normal((A.shape[0], 32)).astype(np.float32)
    Xt = torch.from_numpy(X).to(cuda_device)
    A64 = A.astype(np.float64)
    assert rel_err(op.tr_mul_mat(Xt), torch.from_numpy(A64.T @ X)) <= TOL
    assert rel_err(op.mul_mat(Xt), torch.from_numpy(A64 @ X)) <= TOL


# name -> 2-D pack: chip_smoke.py's phase-3 tile cases
TILE_CASES = {
    **{f"corpus/{name}": (lambda name=name: vt.vbc2d(
        load_corpus()[name].tocsc().astype(np.float32), 4, 4))
       for name in NAMES},
    "mixed_heights": mixed_height_pack,
    "straddling_tile": straddle_pack,
    "rectangular_600x900": lambda: vt.vbc2d(banded(600, 900, 5, 60, 17), 4, 8),
    "default_u8w8": lambda: vt.vbc2d(blocky_matrix(L=2048), 8, 8),
    "zero_height_tile": zero_height_pack,
    **{name: (lambda B2=B2: B2) for name, B2 in lane_group_packs()},
}


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tr_spmv_2d_kernel_matches_plain(case, with_y, cuda_device):
    B2 = TILE_CASES[case]()
    fmt = vt.VBC2DDevice.from_host(B2, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(B2.m, device=cuda_device, generator=g)
    y = torch.randn(B2.n, device=cuda_device, generator=g)
    args = (0.5, 0.25, y) if with_y else ()
    before = vt.tr_spmv_2d.launches
    got = vt.tr_spmv_2d(fmt, x, *args)
    assert vt.tr_spmv_2d.launches == before + 1
    want = vt.tr_spmv_2d_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert got.shape == (B2.n,) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    oracle = B2.tr_mul(x.double().cpu().numpy(), *(
        (0.5, 0.25, y.double().cpu().numpy()) if with_y else ()))
    assert rel_err(got, torch.from_numpy(oracle)) <= TOL


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_tr_spmv_2d_every_lane_group(lanes, cuda_device, monkeypatch):
    """Each lane group on packs that exercise its slots and chunks: mixed
    tile heights, a height-0 tile and an empty stripe, stripes wider than
    a warp, tiles taller than 32 / w rows."""
    from vbcs_tpu_torch.ops import trspmv2d

    monkeypatch.setattr(trspmv2d, "lanes_per_stripe", lambda fmt: lanes)
    for case in ("mixed_heights", "zero_height_tile", "wide_w40", "tall_u9_w8"):
        B2 = TILE_CASES[case]()
        fmt = vt.VBC2DDevice.from_host(B2, cuda_device)
        x = torch.randn(B2.m, device=cuda_device)
        y = torch.randn(B2.n, device=cuda_device)
        got = vt.tr_spmv_2d(fmt, x, 0.5, 0.25, y)
        assert rel_err(got, vt.tr_spmv_2d_plain(fmt, x, 0.5, 0.25, y)) <= TOL


def test_tr_spmv_2d_mixed_heights_exact(cuda_device):
    """Basis vectors through a pack whose stripes mix tile heights: every
    output is one stored value (a wrong running value offset shows here)."""
    B2 = mixed_height_pack()
    assert mixed_stripes(B2) > 0
    fmt = vt.VBC2DDevice.from_host(B2, cuda_device)
    D = torch.from_numpy(B2.to_dense().astype(np.float32))
    for i in range(B2.m):
        e = torch.zeros(B2.m, device=cuda_device)
        e[i] = 1.0
        assert torch.equal(vt.tr_spmv_2d(fmt, e).cpu(), D[i])


def test_tr_spmv_2d_edge_shapes(cuda_device):
    """Empty stripes, an empty row block, a zero-width stripe, n == 0."""
    D = np.zeros((6, 7), np.float32)
    D[0:2, 0:3] = [[1, 2, 3], [4, 5, 6]]
    D[5, 5:7] = [7, 8]
    B2 = vt.pack_vbc2d(vt.CSC.from_scipy(sp.csc_matrix(D)),
                       vt.SplitPartition(np.array([0, 2, 2, 5, 6])),
                       vt.SplitPartition(np.array([0, 3, 3, 5, 7])), 3, 3)
    fmt = vt.VBC2DDevice.from_host(B2, cuda_device)
    x = torch.arange(1, 7, dtype=torch.float32, device=cuda_device)
    y = torch.ones(7, device=cuda_device)
    got = vt.tr_spmv_2d(fmt, x, 2.0, 0.5, y).cpu().numpy()
    np.testing.assert_allclose(got, 2.0 * (D.T @ np.arange(1, 7)) + 0.5,
                               rtol=1e-6)
    B0 = vt.vbc2d(sp.csc_matrix((5, 0), dtype=np.float32), 4, 4)
    f0 = vt.VBC2DDevice.from_host(B0, cuda_device)
    assert vt.tr_spmv_2d(f0, torch.ones(5, device=cuda_device)).shape == (0,)


@pytest.mark.parametrize("plan", ["equi", "default"])
def test_operator_2d_on_card(plan, cuda_device):
    A = blocky2d_matrix(K=512, band=60, seed=2)
    methods = ((vt.AlternatingPacker(vt.EquiChunker(8), vt.EquiChunker(4)),
                vt.AlternatingPacker(vt.EquiChunker(4), vt.EquiChunker(8)))
               if plan == "equi" else (None, None))
    op = vt.VBC2DOperator.from_csc(A, 4, 8, *methods, device=cuda_device)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    y = rng.standard_normal(A.shape[1]).astype(np.float32)
    X = rng.standard_normal((A.shape[1], 32)).astype(np.float32)
    xt, yt, Xt = (torch.from_numpy(a).to(cuda_device) for a in (x, y, X))
    A64 = A.astype(np.float64)
    kernel = vt.tr_spmv_2d if op.route_tr[0] == "tile2d" else vt.tr_spmv
    assert op.route_tr[0] == ("tile2d" if vt.tile2d_worthwhile(op.host_tr) else "view")
    before = kernel.launches
    got = op.tr_mul(xt, 0.5, 0.25, yt)
    assert kernel.launches == before + 1
    assert rel_err(got, torch.from_numpy(0.5 * (A64.T @ x) + 0.25 * y)) <= TOL
    assert rel_err(op.mul(yt), torch.from_numpy(A64 @ y)) <= TOL
    assert rel_err(op.tr_mul_mat(Xt[: A.shape[0]].contiguous()),
                   torch.from_numpy(A64.T @ X[: A.shape[0]])) <= TOL
    assert rel_err(op.mul_mat(Xt), torch.from_numpy(A64 @ X)) <= TOL


def oracle_chain(A, x, n_iters, alpha):
    return torch.from_numpy(chain_oracle(A, x.double().cpu().numpy(), n_iters,
                                         alpha))


# square matrices for the chain: name -> (matrix, W, chunker)
CHAIN_CASES = {
    "uniform8": CASES["uniform8"],
    "multiclass_dp": CASES["multiclass_dp"],
    "long_multigroup_stripes": lambda: (long_stripes(), 8, vt.EquiChunker(8)),
    "flagship_l2048": CASES["flagship_l2048"],
}


@pytest.mark.parametrize("alpha", [None, 0.5])
@pytest.mark.parametrize("n_iters", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_tr_spmv_chain_kernel_matches_plain(case, n_iters, alpha, cuda_device):
    A, W, method = CHAIN_CASES[case]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n_iters)
    x = torch.randn(A.shape[0], device=cuda_device, generator=g)
    before = vt.tr_spmv_chain.launches
    got = vt.tr_spmv_chain(fmt, x, n_iters, alpha)
    assert vt.tr_spmv_chain.launches == before + 1  # one launch per chain
    want = vt.tr_spmv_chain_plain(fmt, x, n_iters, alpha)
    torch.cuda.synchronize()
    assert got.shape == (A.shape[1],) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    assert rel_err(got, oracle_chain(A, x, n_iters, alpha)) <= TOL


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_tr_spmv_chain_small_grids(blocks, cuda_device):
    """Few blocks at the largest budget: each thread walks many columns,
    a block's range may be larger than its shared memory (at 1 block it
    is: partly resident), and the grid barrier still orders the
    iterations."""
    A, W, method = CASES["flagship_l2048"]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    _, budget = chain_grid(cuda_device)
    ranges, resident = chain_bytes(fmt, chain_plan(fmt, blocks, budget))
    assert bool((resident < ranges).any()) == bool((ranges > budget).any())
    x = torch.randn(A.shape[0], device=cuda_device)
    rc, got = launch_chain(fmt, x, 4, 0.25, blocks, budget)
    assert rc == 0
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 4, 0.25)) <= TOL


@pytest.mark.parametrize("residency", ["resident", "partly resident", "streamed"])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_tr_spmv_chain_residency(case, residency, cuda_device):
    """The kernel with its pack in shared memory in full, in part (a
    budget of half the largest block range: ranges split on a stripe
    boundary) and not at all (budget 0), through the C launcher at the
    occupancy grid of each budget, against the plain loop and the f64
    oracle."""
    A, W, method = CHAIN_CASES[case]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    _, blocks, budget = {r[0]: r for r in chain_residencies(fmt, cuda_device)}[
        residency]
    ranges, resident = chain_bytes(fmt, chain_plan(fmt, blocks, budget))
    want_full = {"resident": True, "partly resident": False, "streamed": False}
    assert bool((resident == ranges).all()) == want_full[residency]
    assert bool((resident > 0).any()) == (residency != "streamed")
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(A.shape[0], device=cuda_device, generator=g)
    before = vt.tr_spmv_chain.launches
    rc, got = launch_chain(fmt, x, 5, 0.5, blocks, budget)
    assert rc == 0 and vt.tr_spmv_chain.launches == before
    torch.cuda.synchronize()
    assert got.shape == (A.shape[1],) and torch.isfinite(got).all()
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 5, 0.5)) <= TOL
    assert rel_err(got, oracle_chain(A, x, 5, 0.5)) <= TOL


# packs for the chain's column groups (4 adjacent columns of a stripe):
# float4 rows, a width-5 stripe's group of 4 and group of 1, mixed widths
GROUP_CASES = {
    "width8": CHAIN_CASES["flagship_l2048"],
    "width5": lambda: (banded(300, 300, 6, 50, 4), 5, vt.EquiChunker(5)),
    "multiclass_dp": CHAIN_CASES["multiclass_dp"],
}


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_tr_spmv_chain_column_groups(case, streamed, cuda_device):
    """The chain's column groups, whole and partial, with their values in
    shared memory and read from the pack, against the plain loop and the
    f64 oracle."""
    A, W, method = GROUP_CASES[case]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    blocks, budget = chain_grid(cuda_device, 0 if streamed else -1)
    x = torch.randn(A.shape[0], device=cuda_device)
    rc, got = launch_chain(fmt, x, 3, 0.5, blocks, budget)
    assert rc == 0
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 3, 0.5)) <= TOL
    assert rel_err(got, oracle_chain(A, x, 3, 0.5)) <= TOL


def test_tr_spmv_chain_budget_over_limit_raises(cuda_device):
    """A shared-memory budget over the device's opt-in limit is refused by
    the grid query and by the launcher, and the wrapper still runs."""
    A, W, method = CASES["uniform8"]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    blocks, limit = chain_grid(cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        chain_grid(cuda_device, limit + 16)
    x = torch.randn(A.shape[0], device=cuda_device)
    rc, _ = launch_chain(fmt, x, 3, 1.0, blocks, limit + 16)
    assert rc != 0
    got = vt.tr_spmv_chain(fmt, x, 3)
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 3)) <= TOL


def test_tr_spmv_chain_grid_too_large_raises(cuda_device):
    """A cooperative launch whose blocks cannot all be resident is refused,
    and the launcher's code makes the wrapper's check raise."""
    A, W, method = CASES["uniform8"]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    x = torch.randn(A.shape[0], device=cuda_device)
    rc, _ = launch_chain(fmt, x, 3, 1.0, 1 << 20, 0)
    assert rc != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        _lib.check(_lib.load(), rc, "tr_spmv_chain")
    # the refusal leaves the context usable
    got = vt.tr_spmv_chain(fmt, x, 3)
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 3)) <= TOL


@pytest.mark.parametrize("k", [40, 80])
def test_operator_chain_on_card(k, cuda_device):
    A = fem_matrix(k=k).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, device=cuda_device)
    assert op.row_perm is not None  # RCM shrinks the grids' packs at every k
    x = torch.randn(A.shape[0], device=cuda_device)
    chains, gathers = vt.tr_spmv_chain.launches, vt.gather.launches
    got = op.tr_mul_chain(x, 5, 0.125)
    assert vt.tr_spmv_chain.launches == chains + 1
    assert vt.gather.launches == gathers  # the auto-RCM maps are in the chain
    assert rel_err(got, oracle_chain(A, x, 5, 0.125)) <= TOL
    if op.row_perm is not None:
        composed = vt.gather(vt.tr_spmv_chain(op.dev_tr, vt.gather(x, op.perm_t),
                                              5, 0.125),
                             torch.argsort(op.perm_t).int())
        assert torch.equal(got, composed)
    assert torch.equal(op.tr_mul_chain(x, 0), x)
    with pytest.raises(ValueError, match="square"):
        vt.VBCOperator.from_csc(A[:, :100].tocsc(), device=cuda_device
                                ).tr_mul_chain(x, 2)


SCATTER_PACKS = dict(scatter_packs())


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("case", sorted(SCATTER_PACKS))
def test_tr_spmv_scatter_kernel_matches_plain(case, with_y, cuda_device):
    B = SCATTER_PACKS[case]
    fmt = vt.ScatterDevice.from_host(B, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(B.m, device=cuda_device, generator=g)
    y = torch.randn(B.n, device=cuda_device, generator=g)
    args = (0.5, 0.25, y) if with_y else ()
    before = vt.tr_spmv_scatter.launches
    got = vt.tr_spmv_scatter(fmt, x, *args)
    assert vt.tr_spmv_scatter.launches == before + 1
    want = vt.tr_spmv_scatter_plain(fmt, x, *args)
    torch.cuda.synchronize()
    assert got.shape == (B.n,) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    oracle = B.tr_mul(x.double().cpu().numpy(), *(
        (0.5, 0.25, y.double().cpu().numpy()) if with_y else ()))
    assert rel_err(got, torch.from_numpy(oracle)) <= TOL
    # no float atomics: a second call gives the same bits
    assert torch.equal(vt.tr_spmv_scatter(fmt, x, *args), got)


def route_scatter_packs():
    """The three packs of chip_smoke.py on the scatter route."""
    flag = vt.CSC.from_scipy(blocky_matrix())
    scat = vt.CSC.from_scipy(scattered_matrix().astype(np.float32))
    return {"flagship A.T": flag.transpose(), "scattered A": scat,
            "scattered A.T": scat.transpose()}


@pytest.mark.parametrize("case", ["flagship A.T", "scattered A", "scattered A.T"])
def test_tr_spmv_scatter_route_packs(case, cuda_device):
    B = vt.vbc1d(route_scatter_packs()[case], 8)
    fmt = vt.route_tr_spmv(B, cuda_device)[1]
    assert isinstance(fmt, vt.ScatterDevice)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(B.m, device=cuda_device, generator=g)
    y = torch.randn(B.n, device=cuda_device, generator=g)
    for args in ((), (0.5, 0.25, y)):
        got = vt.tr_spmv_scatter(fmt, x, *args)
        assert rel_err(got, vt.tr_spmv_scatter_plain(fmt, x, *args)) <= TOL
        assert torch.equal(vt.tr_spmv_scatter(fmt, x, *args), got)


# entry counts at the tiles' edges (SCATTER_TILE is a power of two): one
# past, one column, one entry, none
TILE_EDGE = {
    "entries_512": (700, 300, 512),
    "entries_513": (700, 300, 513),
    "one_column": (900, 1, 450),
    "one_entry": (5, 4, 1),
    "no_entry": (6, 5, 0),
}


@pytest.mark.parametrize("case", sorted(TILE_EDGE))
def test_tr_spmv_scatter_tile_edges(case, cuda_device):
    m, n, nnz = TILE_EDGE[case]
    rng = np.random.default_rng(nnz)
    flat = rng.choice(m * n, nnz, replace=False)
    A = coo_matrix(m, n, flat // n, flat % n, nnz)
    fmt = vt.ScatterDevice.from_host(vt.vbc1d(A, 8, vt.EquiChunker(1)), cuda_device)
    assert fmt.row.numel() == nnz
    x = torch.randn(m, device=cuda_device)
    y = torch.randn(n, device=cuda_device)
    for args in ((), (0.5, 0.25, y)):
        got = vt.tr_spmv_scatter(fmt, x, *args)
        assert rel_err(got, vt.tr_spmv_scatter_plain(fmt, x, *args)) <= TOL


def test_tr_spmv_scatter_basis_vectors_exact(cuda_device):
    B = vt.vbc1d(banded(256, 256, 4, 20, 9), 8, vt.EquiChunker(1))
    fmt = vt.ScatterDevice.from_host(B, cuda_device)
    D = torch.from_numpy(B.to_dense().astype(np.float32))
    for i in list(range(0, 256, 37)) + [255]:
        e = torch.zeros(256, device=cuda_device)
        e[i] = 1.0
        assert torch.equal(vt.tr_spmv_scatter(fmt, e).cpu(), D[i, :])


@pytest.mark.parametrize("case", ["fem", "scattered"])
def test_operator_natural_views_on_card(case, cuda_device):
    """The auto-RCM FEM (mean stripe width 1.99) and scattered operators,
    both on the scatter route: every call one launch of its kernel through
    col_out, each kernel against its plain version on the natural views,
    no gather."""
    A = (fem_matrix(k=160) if case == "fem" else scattered_matrix()).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, reorder="auto", device=cuda_device)
    assert op.row_perm is not None
    assert op.route_tr[0] == op.route_fw[0] == "scatter"
    kernel = vt.tr_spmv_scatter
    n = A.shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(n, device=cuda_device, generator=g)
    y = torch.randn(n, device=cuda_device, generator=g)
    X = torch.randn(n, 32, device=cuda_device, generator=g)
    A64 = A.astype(np.float64)
    xn, yn, Xn = (t.double().cpu().numpy() for t in (x, y, X))
    gathers = vt.gather.launches
    for fn, fmt, want in (("tr_mul", op.route_tr[1], 0.5 * (A64.T @ xn) + 0.25 * yn),
                          ("mul", op.route_fw[1], 0.5 * (A64 @ xn) + 0.25 * yn)):
        assert torch.equal(fmt.col_out, op.perm_t)
        before = kernel.launches
        got = getattr(op, fn)(x, 0.5, 0.25, y)
        assert kernel.launches == before + 1
        assert rel_err(got, torch.from_numpy(want)) <= TOL
        assert rel_err(got, vt.tr_spmv_plain(fmt, x, 0.5, 0.25, y)) <= TOL
    for fn, fmt, want in (("tr_mul_mat", op.nat_tr, A64.T @ Xn),
                          ("mul_mat", op.nat_fw, A64 @ Xn)):
        before = vt.tr_spmm.launches
        got = getattr(op, fn)(X)
        assert vt.tr_spmm.launches == before + 1
        assert rel_err(got, torch.from_numpy(want)) <= TOL
        assert rel_err(got, vt.tr_spmm_plain(fmt, X)) <= TOL
    assert vt.gather.launches == gathers


@pytest.mark.parametrize("reorder", ["never", "auto"])
def test_operator_scatter_route_on_card(reorder, cuda_device):
    """An unstructured matrix: both directions take the scatter route,
    natural and relabeled by auto-RCM."""
    rng = np.random.default_rng(9)
    n, nnz = 8000, 56000
    A = sp.coo_matrix((rng.standard_normal(nnz).astype(np.float32),
                       (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
                      shape=(n, n)).tocsc()
    A.sum_duplicates()
    op = vt.VBCOperator.from_csc(A, W=8, reorder=reorder, device=cuda_device)
    assert (op.row_perm is not None) == (reorder == "auto")
    assert op.route_tr[0] == op.route_fw[0] == "scatter"
    x = torch.randn(A.shape[0], device=cuda_device)
    y = torch.randn(A.shape[1], device=cuda_device)
    before = vt.tr_spmv_scatter.launches
    got = op.tr_mul(x, 0.5, 0.25, y)
    assert vt.tr_spmv_scatter.launches == before + 1
    A64 = A.astype(np.float64)
    want = 0.5 * (A64.T @ x.double().cpu().numpy()) + 0.25 * y.double().cpu().numpy()
    assert rel_err(got, torch.from_numpy(want)) <= TOL


@pytest.mark.parametrize("R, m", [(1, 1000), (3, 3000), (8, 8192), (313, 320_000),
                                  (313, 313 * 1024 - 3), (5, 4099)])
@pytest.mark.parametrize("aligned", [True, False])
def test_tile_relayout_kernel_bitwise(R, m, aligned, cuda_device):
    """Every size against the plain version, bitwise: m % 4 != 0 ends x
    inside a 16-byte vector (the scalar tail), and an x 4 bytes past a
    16-byte boundary takes the scalar path throughout."""
    x = torch.randn(m + 1, device=cuda_device)
    x = x[:m] if aligned else x[1:]
    assert (x.data_ptr() % 16 == 0) == aligned
    before = vt.tile_relayout.launches
    got = vt.tile_relayout(x, R)
    assert vt.tile_relayout.launches == before + 1
    assert torch.equal(got, vt.tile_relayout_plain(x, R))


def test_tr_spmv_chain_barrier_counter_wraps(cuda_device):
    """The grid barrier's counter started 5 rounds short of 2^32: the
    targets of rounds 5-9 wrap past 2^32, and the wrap-safe comparison
    still orders the 10 iterations."""
    A, W, method = CASES["flagship_l2048"]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    blocks, budget = chain_grid(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(A.shape[0], device=cuda_device, generator=g)
    rc, got = launch_chain(fmt, x, 10, 0.25, blocks, budget,
                           start=2**32 - 5 * blocks)
    assert rc == 0
    torch.cuda.synchronize()
    assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, 10, 0.25)) <= TOL
    assert rel_err(got, oracle_chain(A, x, 10, 0.25)) <= TOL


def test_tr_spmv_chain_split_across_launches(cuda_device, monkeypatch):
    """At a cap of 3 iterations a launch, a chain of 10 is 4 launches
    (3, 3, 3, 1) handing x over between them, alpha in each."""
    from vbcs_tpu_torch.ops import chain

    monkeypatch.setattr(chain, "MAX_LAUNCH_ITERS", 3)
    A, W, method = CHAIN_CASES["multiclass_dp"]()
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), cuda_device)
    x = torch.randn(A.shape[0], device=cuda_device)
    for n_iters, launches in ((10, 4), (9, 3), (4, 2), (1, 1)):
        before = vt.tr_spmv_chain.launches
        got = vt.tr_spmv_chain(fmt, x, n_iters, 0.5)
        assert vt.tr_spmv_chain.launches == before + launches
        assert rel_err(got, vt.tr_spmv_chain_plain(fmt, x, n_iters, 0.5)) <= TOL
        assert rel_err(got, oracle_chain(A, x, n_iters, 0.5)) <= TOL


def relabeled_pack(device):
    """The FEM k=80 operator's relabeled pack (auto-RCM) and perm."""
    A = fem_matrix(k=80).astype(np.float32)
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device=device)
    assert op.row_perm is not None
    return A, op


@pytest.mark.parametrize("n_iters", [1, 2, 5])
@pytest.mark.parametrize("residency", ["resident", "partly resident", "streamed"])
def test_tr_spmv_chain_mapped_is_composed(residency, n_iters, cuda_device):
    """The chain with the auto-RCM perm folded in (x gathered through it
    before iteration 0, which reads it from its staged window or from L2;
    y stored through it after the last) is bitwise the unmapped chain
    between two gathers, at each residency of the pack."""
    A, op = relabeled_pack(cuda_device)
    fmt, perm = op.dev_tr, op.perm_t
    x = torch.randn(A.shape[0], device=cuda_device)
    runs = {r: (b, bud) for r, b, bud in chain_residencies(fmt, cuda_device)}
    blocks, budget = runs[residency]
    rc, got = launch_chain(fmt, x, n_iters, 0.5, blocks, budget, perm=perm)
    assert rc == 0
    rc, inner = launch_chain(fmt, vt.gather(x, perm), n_iters, 0.5, blocks, budget)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(got, vt.gather(inner, torch.argsort(op.perm_t).int()))
    assert rel_err(got, oracle_chain(A, x, n_iters, 0.5)) <= TOL


def test_tr_spmv_chain_mapped_split_across_launches(cuda_device, monkeypatch):
    """At a cap of 3 iterations a launch, the mapped chain reads x through
    perm in its first launch and stores through it in its last: bitwise
    the composed path over the same split, one launch a piece."""
    from vbcs_tpu_torch.ops import chain

    monkeypatch.setattr(chain, "MAX_LAUNCH_ITERS", 3)
    A, op = relabeled_pack(cuda_device)
    x = torch.randn(A.shape[0], device=cuda_device)
    for n_iters, launches in ((10, 4), (4, 2), (3, 1), (1, 1)):
        before, gathers = vt.tr_spmv_chain.launches, vt.gather.launches
        got = vt.tr_spmv_chain(op.dev_tr, x, n_iters, 0.5, op.perm_t)
        assert vt.tr_spmv_chain.launches == before + launches
        assert vt.gather.launches == gathers
        want = vt.gather(vt.tr_spmv_chain(op.dev_tr, vt.gather(x, op.perm_t),
                                          n_iters, 0.5),
                         torch.argsort(op.perm_t).int())
        assert torch.equal(got, want)


def test_halo_paths_on_card(cuda_device):
    """The halo paths in two gloo ranks sharing the card: each rank's
    launches (1-D halo: one tile copy and one stripe launch; overlap: one
    tile copy and two stripe launches into one buffer; 2-D halo: two tile
    copies and the tile kernel; no element gather), every kernel within
    TOL of its plain version on the path's inputs (the tile copy
    bitwise), and y bitwise the replicated path's."""
    from vbcs_tpu_torch import entry
    from vbcs_tpu_torch.parallel import comm

    A1 = blocky_matrix(L=4096, band=400)
    B1 = vt.vbc1d(A1, 8)
    x1 = np.random.default_rng(3).standard_normal(A1.shape[0]).astype(np.float32)
    B2 = straddle_pack()
    x2 = np.random.default_rng(4).standard_normal(B2.m).astype(np.float32)
    jobs = [{"path": p, "B": B1, "x": x1} for p in ("replicated", "halo", "overlap")]
    jobs += [{"path": p, "B": B2, "x": x2} for p in ("2d", "2d_halo")]
    want = {"halo": {"tr_spmv": 1, "gather_tiles": 1},
            "overlap": {"tr_spmv": 2, "gather_tiles": 1},
            "2d_halo": {"tr_spmv_2d": 1, "gather_tiles": 2}}
    ranks = comm.run_ranks(entry.rank_paths, 2, "gloo", "cuda:0", jobs)
    for rank in ranks:
        for rec in rank:
            if rec["path"] in want and rec["stats"]["columns"]:
                assert rec["launches"] == want[rec["path"]], rec
            for kernel, (_, rel) in rec["plain"].items():
                assert rel == 0.0 if kernel == "gather_tiles" else rel <= TOL
    y = {rec["path"]: rec["y"] for rec in ranks[0]}
    np.testing.assert_array_equal(y["halo"], y["replicated"])
    np.testing.assert_array_equal(y["overlap"], y["replicated"])
    np.testing.assert_array_equal(y["2d_halo"], y["2d"])


def test_probe_add_one_kernel(cuda_device):
    from vbcs_tpu_torch.probes import probe_launch as pl_

    x = torch.randn(8, 128, device=cuda_device)
    before = pl_.add_one.launches
    got = pl_.add_one(x)
    assert pl_.add_one.launches == before + 1
    assert torch.equal(got, pl_.add_one_plain(x))
    y = torch.randn(1000, device=cuda_device)
    assert torch.equal(pl_.add_one(y), y + 1.0)


def test_probe_launch_graph_replays_the_eager_steps(cuda_device):
    from vbcs_tpu_torch.probes import probe_launch as pl_

    x0, xb = (t.to(cuda_device) for t in pl_.inputs())
    for kind in pl_.STEPS:
        x = xb if kind == "pad" else x0
        want = pl_.chained(kind, x, 7)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = pl_.chained(kind, x, 7)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def chunk_cases():
    from vbcs_tpu_torch.probes import probe_kernel, probe_kernel2

    cases = {f"probe_kernel {v}": (v, kw) for _, v, kw in probe_kernel.VARIANTS}
    cases.update({f"probe_kernel2 {name.split()[0]} {v}": (v, kw)
                  for name, v, kw in probe_kernel2.VARIANTS})
    return cases


CHUNK_CASES = chunk_cases()


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_probe_chunk_kernel_matches_plain(case, cuda_device):
    """Every chunk variant at full size (T = 39) on its probe's inputs."""
    from vbcs_tpu_torch.probes import chunk, probe_kernel, probe_kernel2

    variant, kw = CHUNK_CASES[case]
    probe = probe_kernel if case.startswith("probe_kernel ") else probe_kernel2
    inp = probe.inputs(**kw).to(cuda_device)
    before = chunk.chunk.launches
    got = chunk.chunk(variant, inp)
    assert chunk.chunk.launches == before + 1
    want = chunk.chunk_plain(variant, inp)
    torch.cuda.synchronize()
    assert got.shape == (8, 39 * 1024) and torch.isfinite(got).all()
    if variant in chunk.BITWISE:
        assert torch.equal(got, want)
    else:
        assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("n_iters", [1, 2, 3])
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_probe_chain_kernel_matches_plain(variant, n_iters, cuda_device):
    """One cooperative launch of the chain probe at full size (T = 40)."""
    from vbcs_tpu_torch.probes import probe_chain

    wblk = dict((v, w) for _, v, w in probe_chain.VARIANTS)[variant]
    inp = probe_chain.inputs(wblk=wblk).to(cuda_device)
    before = probe_chain.chain.launches
    got = probe_chain.chain(variant, inp, n_iters)
    assert probe_chain.chain.launches == before + 1
    want = probe_chain.chain_plain(variant, inp, n_iters)
    torch.cuda.synchronize()
    assert got.shape == (8, 40 * 1024) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL


# (T, blocks, budget; None: the launcher's default) of the chain probe's
# plans: one chunk; ranges starting at chunk starts (D's halo columns); a
# forced small grid whose ranges pass the budget (spill); resident parts
# ending at a chunk's last column; blocks with nothing resident, one
# starting at 1024 (its carry from global memory); a small budget (partly
# resident); budget 0 (all streamed)
PROBE_CHAIN_PLANS = [(1, None, None), (3, 6, None), (5, 7, None), (40, 2, None),
                     (3, 4, 95000), (2, 2, 320), (40, None, 40000), (40, None, 0)]


@pytest.mark.parametrize("plan", PROBE_CHAIN_PLANS, ids=str)
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_probe_chain_kernel_plans(variant, plan, cuda_device):
    """The chain probe at every kind of block range against its plain
    version, x1-3; D bitwise B but at chunk starts, where it adds the
    carry."""
    from vbcs_tpu_torch.probes import probe_chain as pc

    T, blocks, budget = plan
    wblk = dict((v, w) for _, v, w in pc.VARIANTS)[variant]
    inp = pc.inputs(T, wblk).to(cuda_device)
    fit, b = pc.grid(cuda_device, variant, -1 if budget is None else budget)
    p = pc.plan(T * 1024, fit if blocks is None else blocks, b, variant, wblk)
    if (T, blocks) == (3, 6):
        assert p.halo.sum() == (2 if variant == "D" else 0)
    if (T, blocks) in ((40, 2), (3, 4)) or budget == 40000:
        assert (p.spill > 0).all() and (p.resident > 0).all()
    if budget in (0, 320):
        assert (p.resident == 0).all()
    for n in (1, 2, 3):
        got = pc.chain(variant, inp, n, blocks, budget)
        want = pc.chain_plain(variant, inp, n)
        torch.cuda.synchronize()
        assert got.shape == (8, T * 1024) and torch.isfinite(got).all()
        assert rel_err(got, want) <= TOL, n
    if variant == "D":
        d = pc.chain("D", inp, 1, blocks, budget)
        bb = pc.chain("B", inp, 1, blocks, budget)
        s = torch.arange(1, T, device=cuda_device) * 1024
        rest = torch.ones(T * 1024, dtype=torch.bool, device=cuda_device)
        rest[s] = False
        assert torch.equal(d[:, rest], bb[:, rest])
        if T > 1:
            assert rel_err(d[:, s], bb[:, s] + bb[:, s - 1]) <= TOL


def test_probe_chain_refuses_what_does_not_fit(cuda_device):
    """A budget over the card's limit or a grid that cannot be resident
    raises; nothing falls back."""
    from vbcs_tpu_torch.probes import probe_chain as pc

    inp = pc.inputs(2).to(cuda_device)
    fit, optin = pc.grid(cuda_device, "B")
    before = pc.chain.launches
    with pytest.raises(RuntimeError, match="grid"):
        pc.grid(cuda_device, "B", optin + 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        pc.chain("B", inp, 1, budget=optin + 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        pc.chain("B", inp, 1, blocks=fit + 1)
    off = torch.empty(inp.xin.numel() + 1, device=cuda_device)[1:].view_as(inp.xin)
    with pytest.raises(ValueError, match="16 bytes"):  # read as float4
        pc.chain("B", inp._replace(xin=off), 1)
    assert pc.chain.launches == before
    got = pc.chain("B", inp, 2)  # the card still launches it
    assert rel_err(got, pc.chain_plain("B", inp, 2)) <= TOL


def test_probe_spmm4_fma_kernel_matches_plain(cuda_device):
    """The FMA at full size (T = 157: Xg and out 164.6 MB each)."""
    from vbcs_tpu_torch.probes import probe_spmm4

    inp = probe_spmm4.inputs(m=10).to(cuda_device)
    before = probe_spmm4.fma.launches
    got = probe_spmm4.fma(inp.Xg, inp.Vl)
    assert probe_spmm4.fma.launches == before + 1
    want = probe_spmm4.fma_plain(inp.Xg, inp.Vl)
    torch.cuda.synchronize()
    assert got.shape == (157 * 2048, 128) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL
    assert rel_err(probe_spmm4.fma_library(inp.Xg, inp.Vl), want) <= TOL


# ---- the non-f32 routes, the CSC baseline and the autotuner on the card

@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("dtype", ["float64", "int32", "bool"])
def test_semiring_routes_on_card(dtype, shape, cuda_device):
    """A non-f32 matrix runs ``ops/semiring.py`` on CUDA tensors (no
    kernel launch) — but the 1-D f64 ``tr_mul``, one launch of the stripe
    kernel's f64 map: f64 within 1e-12 of scipy's f64 product, int32 and
    bool matrices exact with an int32 x."""
    A = blocky_matrix(L=512).astype(np.float64)
    if dtype != "float64":
        A = (A != 0) if dtype == "bool" else A.astype(np.int32)
        A.data = np.ones_like(A.data) if dtype == "bool" else (
            np.random.default_rng(3).integers(-4, 5, A.nnz).astype(np.int32))
    A = sp.csc_matrix(A)
    op = (vt.VBCOperator.from_csc(A, W=8, device=cuda_device) if shape == "1d"
          else vt.VBC2DOperator.from_csc(A, 4, 8, device=cuda_device))
    rng = np.random.default_rng(4)
    m, n = A.shape
    if dtype == "float64":
        x, X = rng.standard_normal(m), rng.standard_normal((m, 5))
    else:
        x = rng.integers(-4, 5, m).astype(np.int32)
        X = rng.integers(-4, 5, (m, 5)).astype(np.int32)
    launched = vt.tr_spmv.launches + vt.tr_spmv_2d.launches + vt.tr_spmm.launches
    y = op.tr_mul(torch.from_numpy(x).to(cuda_device))
    f64_map = int(dtype == "float64" and shape == "1d")  # the f64 staged map
    assert vt.tr_spmv.launches + vt.tr_spmv_2d.launches + vt.tr_spmm.launches == (
        launched + f64_map)
    Y = op.tr_mul_mat(torch.from_numpy(X).to(cuda_device))
    assert vt.tr_spmv.launches + vt.tr_spmv_2d.launches + vt.tr_spmm.launches == (
        launched + f64_map)
    Ai = A.astype(np.float64 if dtype == "float64" else np.int64)
    for got, want in ((y, Ai.T @ x), (Y, Ai.T @ X)):
        assert got.device.type == "cuda" and got.dtype == torch.from_numpy(x).dtype
        if dtype == "float64":
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), want)


def test_csc_baseline_on_card(cuda_device):
    A = blocky_matrix(L=512)
    C = vt.CSC.from_scipy(A)
    x = np.random.default_rng(5).standard_normal(A.shape[0])
    for dtype in (np.float32, np.float64):
        cdev = vt.CSCDevice.from_host(C, dtype=dtype, device=cuda_device)
        xt = torch.from_numpy(x.astype(dtype)).to(cuda_device)
        for got, want in ((vt.csc_tr_spmv(cdev, xt), A.T.astype(np.float64) @ x),
                          (vt.csc_spmv(cdev, xt[: A.shape[1]]),
                           A.astype(np.float64) @ x[: A.shape[1]])):
            assert got.dtype == xt.dtype
            tol = 2e-5 if dtype == np.float32 else 1e-12
            assert rel_err(got, torch.from_numpy(want)) <= tol


def test_autotune_sample_on_card(cuda_device):
    """One timed sample of each autotuner, through the routes ``tr_mul``
    takes: a plausible positive time (at least the card's bound)."""
    from vbcs_tpu_torch.models import autotune as at

    B = vt.vbc1d(at._synth(2048, 4, 8, 400, seed=1), 8, vt.EquiChunker(4))
    t, name = at._measure_shipped(B, cuda_device)
    assert name == vt.route_tr_spmv(B, cuda_device)[0] and t is not None and t > 0
    A2 = at._synth2d(2048, 4, 1024, 8, 8, 400, seed=2)
    B2 = vt.vbc2d(A2, 8, 8, (vt.SplitPartition.equi(A2.shape[0], 4),
                              vt.SplitPartition.equi(A2.shape[1], 8)))
    t2, name2 = at._measure_shipped_2d(B2, cuda_device)
    assert name2 == "tile2d" and t2 is not None and t2 > 0



# ---- slice 10: the split-point DP (csrc/dp.cu) ----------------------------

def _dp_models(W, m):
    rng = np.random.default_rng(W)
    fitted_1d = vt.ColumnBlockComponentCostModel(
        np.cumsum(rng.uniform(0.1, 1.3, W)) * 0.37,
        np.cumsum(rng.uniform(0.01, 0.2, W)) * 0.29)
    fitted_2d = vt.BlockComponentCostModel(
        alpha_row=1.0, alpha_col=np.cumsum(rng.uniform(0.1, 1.3, W)) * 0.41,
        beta_row=(np.cumsum(rng.uniform(0.1, 0.5, 4)) * 0.3, rng.uniform(0.05, 0.3, 4)),
        beta_col=(np.cumsum(rng.uniform(0.01, 0.2, W)) * 0.7,
                  np.cumsum(rng.uniform(0.01, 0.1, W))))
    return [(vt.model_1dvbc_memory(4, 8), None), (fitted_1d, None),
            (vt.model_vbc_memory(4, 8), vt.SplitPartition.equi(m, 3)),
            (fitted_2d, vt.SplitPartition.equi(m, 4))]


@pytest.mark.parametrize("W", [1, 5, 8, 16, 24, 32, 33])
def test_dp_kernels_match_plain(W, cuda_device):
    """The DP kernels bitwise against their plain versions (S, opt, prev):
    the table, the serial fold in the register ring (W <= 8: 1, 5, 8) and
    past it (16 to 33: the plain loop), the scan (rings in registers to
    W = 16, the device-memory path from 17: 24, 32, 33) and the checked
    fold (also equal to the serial fold on every table); and the split
    points against the host C++ DP, each model on its route."""
    from vbcs_tpu_torch.ops import dp as dp_ops
    from vbcs_tpu_torch.plan.device_dp import dp_inputs
    from vbcs_tpu_torch.plan.dynamic import dp_partition

    for seed, shape in enumerate(((300, 2000), (2000, 300), (50, 3000))):
        A = vt.CSC.from_scipy(sp.random(*shape, 0.03, random_state=seed, format="csc"))
        for model, Pi in _dp_models(W, shape[0]):
            pos, grp, wts, alpha, beta, exact = dp_inputs(A, model, W, Pi,
                                                          device=cuda_device)
            prevcol = dp_ops.prev_occurrence(pos, grp)
            S = dp_ops.dp_table(pos, grp, prevcol, wts, alpha, beta, W)
            S_plain = dp_ops.dp_table_plain(pos, grp, prevcol, wts, alpha, beta, W)
            prev, opt = dp_ops.dp_recurrence_serial(S)
            prev_plain, opt_plain = dp_ops.dp_recurrence_plain(S_plain)
            scan_prev, scan_opt = dp_ops.dp_recurrence_scan(S)
            scan_plain = dp_ops.dp_recurrence_scan_plain(S_plain)
            checked = dp_ops.dp_recurrence_checked(S, scan_prev)
            checked_plain = dp_ops.dp_recurrence_checked_plain(S_plain, scan_plain[0])
            torch.cuda.synchronize()
            assert torch.equal(S, S_plain)
            assert torch.equal(opt, opt_plain) and torch.equal(prev, prev_plain)
            assert torch.equal(scan_opt, scan_plain[1])
            assert torch.equal(scan_prev, scan_plain[0])
            assert all(torch.equal(a, b) for a, b in zip(checked, checked_plain))
            assert torch.equal(checked[1], opt) and torch.equal(checked[0], prev)
            if exact:
                assert torch.equal(scan_opt, opt) and torch.equal(scan_prev, prev)
            got = (vt.dp_partition_device(A, model, W, device=cuda_device) if Pi is None
                   else vt.dp_partition_device_2d(A, model, W, Pi, device=cuda_device))
            np.testing.assert_array_equal(
                got.spl, dp_partition(A, model, W, row_partition=Pi).spl)


def _scan_case(n, W, seed, exact):
    """S [n, W] as the table makes it (inf where w > jp): small integers
    (exact, many ties) or fractions (inexact)."""
    rng = np.random.default_rng(seed)
    S = (rng.integers(1, 9, (n, W)).astype(np.float64) if exact
         else rng.uniform(0.1, 3.0, (n, W)))
    S[np.triu_indices(min(n, W), 1)] = np.inf
    return torch.from_numpy(S)


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 17, 24, 32, 33])
def test_dp_scan_edges(W, cuda_device):
    """The scan kernel against its plain version, bitwise, at the edges of
    its chunks (L = 64 rows) and blocks, on exact S (also equal to the
    serial fold) and on fractional S (the same order of sums: still equal
    to its plain version)."""
    from vbcs_tpu_torch.ops import dp as dp_ops

    L = dp_ops.SCAN_ROWS
    for n in (1, 2, L - 1, L, L + 1, 5 * L + 3, 300 * L + 17):
        We, _, K, B, nb = dp_ops.scan_layout(n, W)
        for exact in (True, False):
            S = _scan_case(n, W, n + W, exact)
            got = dp_ops.dp_recurrence_scan(S.to(cuda_device))
            want = dp_ops.dp_recurrence_scan_plain(S.to(cuda_device))
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), (n, W, exact)
            assert torch.equal(got[0], want[0]), (n, W, exact)
            if exact:
                serial = dp_ops.dp_recurrence_plain(S)
                assert torch.equal(got[1].cpu(), serial[1])
                assert torch.equal(got[0].cpu(), serial[0])


def test_dp_table_window_in_device_memory(cuda_device):
    """R * W too large for shared memory: the table's window in a scratch
    buffer (the size the kernel's source asks for); W = 2,100, a width
    past the columns of the matrix, on the serial fold's plain loop and on
    the scan's device-memory path; and columns whose nonzeros overflow the
    table's staging (a 5,000-entry column) on both of its window paths."""
    from vbcs_tpu_torch.ops import dp as dp_ops
    from vbcs_tpu_torch.plan.device_dp import dp_inputs

    A = vt.CSC.from_scipy(sp.random(200, 700, 0.05, random_state=3, format="csc"))
    W = 50
    mdl = vt.BlockComponentCostModel(
        alpha_row=2.0, alpha_col=np.linspace(5, 9, W),
        beta_row=tuple(np.array([1.0, 1.5]) * k for k in (1, 2, 3, 4, 5)),
        beta_col=tuple(np.linspace(1, 2.5, W) * k for k in (1, .5, .25, .3, .2)))
    dense = sp.random(6000, 400, 0.004, random_state=5, format="lil")
    dense[:5000, 150] = 1.0
    D = vt.CSC.from_scipy(dense.tocsc())
    for C, model, W, Pi in ((A, mdl, 50, vt.SplitPartition.equi(200, 2)),
                            (A, vt.model_1dvbc_memory(4, 8), 2100, None),
                            (D, vt.model_1dvbc_memory(4, 8), 8, None),
                            (D, mdl, 50, vt.SplitPartition.equi(6000, 2)),
                            (D, vt.model_vbc_memory(4, 8), 8,
                             vt.SplitPartition.equi(6000, 3))):
        inputs = dp_inputs(C, model, W, Pi, device=cuda_device)
        prevcol = dp_ops.prev_occurrence(*inputs[:2])
        S = dp_ops.dp_table(inputs[0], inputs[1], prevcol, *inputs[2:5], W)
        S_plain = dp_ops.dp_table_plain(inputs[0], inputs[1], prevcol, *inputs[2:5], W)
        assert torch.equal(S, S_plain)
        prev, opt = dp_ops.dp_recurrence_serial(S)
        prev_plain, opt_plain = dp_ops.dp_recurrence_plain(S_plain)
        assert torch.equal(opt, opt_plain) and torch.equal(prev, prev_plain)
        checked = dp_ops.dp_recurrence_checked(S, prev)
        assert torch.equal(checked[1], opt) and torch.equal(checked[0], prev)
        assert checked[2].tolist() == [0, 0, 0]
        scan = dp_ops.dp_recurrence_scan(S)
        scan_plain = dp_ops.dp_recurrence_scan_plain(S_plain)
        assert torch.equal(scan[1], scan_plain[1]) and torch.equal(scan[0], scan_plain[0])
        if inputs[5]:
            assert torch.equal(scan[1], opt) and torch.equal(scan[0], prev)


def test_dp_routes_on_card(cuda_device):
    """Exact tables launch the scan once a plan, fitted ones the scan (the
    guess) and the checked fold once each; no plan launches the serial
    fold; the stages hold the checked fold's counters; the device backtrack
    equals the host loop."""
    from vbcs_tpu_torch.ops import dp as dp_ops
    from vbcs_tpu_torch.plan import device_dp

    A = vt.CSC.from_scipy(sp.random(300, 2000, 0.03, random_state=1, format="csc"))
    kernels = (dp_ops.dp_recurrence_scan, dp_ops.dp_recurrence_checked,
               dp_ops.dp_recurrence_serial)
    for model, Pi in _dp_models(8, 300):
        for k in kernels:
            k.launches = 0
        exact = device_dp.dp_inputs(A, model, 8, Pi, device=cuda_device)[5]
        got, stages = device_dp.dp_stages(A, model, 8, Pi, device=cuda_device)
        assert stages["route"] == ("scan" if exact else "checked")
        assert [k.launches for k in kernels] == ([1, 0, 0] if exact else [1, 1, 0])
        assert stages["folded"] == 0 and stages["restarts"] >= 0
        prev, _ = device_dp.dp_prev(*device_dp.dp_inputs(A, model, 8, Pi,
                                                         device=cuda_device), 8)
        assert device_dp.backtrack(prev) == device_dp._backtrack(prev.tolist(), A.n)
        assert got == device_dp.backtrack(prev)


def test_dp_flagship_split_points(cuda_device):
    """The flagship and the FEM, 1-D and 2-D, planned on the card, equal
    to the host C++ DP's."""
    from vbcs_tpu_torch.plan.dynamic import dp_partition

    F = vt.CSC.from_scipy(blocky_matrix())
    Fe = vt.CSC.from_scipy(fem_matrix(k=320))
    for A in (F, Fe):
        got = vt.dp_partition_device(A, vt.model_1dvbc_memory(4, 8), 8, device=cuda_device)
        np.testing.assert_array_equal(
            got.spl, dp_partition(A, vt.model_1dvbc_memory(4, 8), 8).spl)
    Pi = vt.SplitPartition.equi(F.m, 8)
    got = vt.dp_partition_device_2d(F, vt.model_vbc_memory(4, 8), 8, Pi, device=cuda_device)
    np.testing.assert_array_equal(
        got.spl, dp_partition(F, vt.model_vbc_memory(4, 8), 8, row_partition=Pi).spl)


def test_dp_chain_floor_matches_plain(cuda_device):
    from vbcs_tpu_torch.ops import dp as dp_ops

    s = torch.tensor([1.0, 3.0, 2.0, 5.0, 4.0, 7.0, 6.0, 8.0, 1e300],
                     dtype=torch.float64, device=cuda_device) * 1e-3
    for n in (0, 8, 4096):
        assert torch.equal(dp_ops.chain_floor(s, n), dp_ops.chain_floor_plain(s, n))


# ---- the checked speculative fold (csrc/dp_checked.cu) --------------------

def _fitted_S(n, W, seed):
    """S [n, W] like a fitted table's (fractional; inf where w > jp)."""
    return _scan_case(n, W, seed, exact=False) * 0.37


@pytest.mark.parametrize("W", [1, 2, 5, 8, 9, 16, 24, 33])
def test_dp_checked_matches_plain(W, cuda_device):
    """The checked fold bitwise against its plain version (prev, opt and the
    counters) and the serial kernel, on fitted and exact S, with the scan's
    guess, with every 97th and every 3rd pointer moved (restarts) and with
    every pointer moved (the budget spent, the host-order fold: its values
    in 8 or 16 registers up to W = 16, from the value ring above), at n
    around its chunk of 256 rows."""
    from vbcs_tpu_torch.ops import dp as dp_ops

    for n in (1, 2, 255, 256, 257, 5000):
        for exact in (False, True):
            S = (_scan_case(n, W, n + W, True) if exact else _fitted_S(n, W, n + W)).to(
                cuda_device)
            serial = dp_ops.dp_recurrence_serial(S)
            guess = dp_ops.dp_recurrence_scan(S)[0]
            for every in (None, 97, 3, 1):
                g = guess if every is None else corrupt_guess(guess, W, every)
                got = dp_ops.dp_recurrence_checked(S, g)
                want = dp_ops.dp_recurrence_checked_plain(S, g)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (n, exact, every)
                assert torch.equal(got[0], serial[0]) and torch.equal(got[1], serial[1])
                if every is not None and W > 1 and n >= 97:
                    assert got[2][0] > 0
                if every == 1 and W > 1 and n >= 97:
                    assert got[2][2] > 0


def test_dp_checked_opt_as_its_ring(cuda_device):
    """Widths whose value ring (3 chunks and W values) passes shared memory
    walk with opt itself as the ring: every plan ties (S = w / 2, exact
    sums), the first minimum is w = 1 everywhere, and a guess with every
    2,000th pointer moved to another width restarts there."""
    from vbcs_tpu_torch.ops import dp as dp_ops

    n, W = 15700, 15650
    w = torch.arange(1, W + 1, device=cuda_device)
    S = (w * 0.5).to(torch.float64).expand(n, W).clone()
    S.masked_fill_(w[None] > torch.arange(1, n + 1, device=cuda_device)[:, None],
                   float("inf"))
    guess = torch.arange(-1, n, device=cuda_device).clamp(min=0)
    for g in (guess, corrupt_guess(guess, W, 2000)):
        got = dp_ops.dp_recurrence_checked(S, g)
        want = dp_ops.dp_recurrence_checked_plain(S, g)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(got[0][1:], torch.arange(n, device=cuda_device))
    assert got[2][0] > 0 and got[2][2] == 0
