"""The port's 2-D TrSpMV (``ops/trspmv2d.py``) against the JAX 2-D kernels.

The JAX package runs a 2-D TrSpMV through ``tr_spmv_pallas_2d``: stripes
whose tiles share one height go to the u-blocked kernel
``_class_kernel2d``, mixed-height stripes to the 1-D stream kernel
``pallas_trspmv2._class_kernel2``.  Each case here packs one JAX
``VBC2D`` and runs it through ``tr_spmv_pallas_2d`` (Pallas in interpret
mode) and through the port's ``tr_spmv_2d`` on
``VBC2DDevice.from_host`` of the very same pack; a spy on ``_run_class2``
shows which JAX route ran.  On the CPU the port's wrapper runs its plain
PyTorch version; the CUDA kernel is held against that plain version on
the card in ``test_torch_cuda.py``.  ``_class_kernel2`` on its own 1-D
route (``tr_spmv_pallas2`` on a multi-class pack) is held against the
port's stripe ``tr_spmv``.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX kernel and the f64
host oracle — f32 sums in different orders (the bound of
``tests/test_pallas_2d.py``, 1e-5 against scipy, plus the JAX kernel's
own rounding).  On basis vectors each output is one stored value times
1, so the result must equal ``to_dense`` exactly.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from corpus import load_corpus
from vbcs_tpu.ops import pallas_trspmv as pk1
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import pallas_trspmv2d as pk2d
from vbcs_tpu.ops import windowed_gather as wg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import zero_height_pack  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pk1, pk2, pk2d, wg):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    yield


@pytest.fixture
def class2_spy(monkeypatch):
    """Counts the JAX 1-D stream kernel's class runs (``_run_class2``)."""
    calls = []
    orig = pk2._run_class2

    def spy(c, x2d):
        calls.append((c.w, c.num_chunks))
        return orig(c, x2d)

    monkeypatch.setattr(pk2, "_run_class2", spy)
    return calls


def banded(m, n, d, band, seed):
    r = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for j in range(n):
        c = int(j * m / n)
        rr = np.unique(np.clip(c + r.integers(-band, band, d), 0, m - 1))
        rows.extend(rr)
        cols.extend([j] * rr.size)
        vals.extend(r.standard_normal(rr.size))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()


def blocky(mb, nb, u, w, density, seed):
    """Random block matrix with exact u x w dense tiles."""
    r = np.random.default_rng(seed)
    mask = r.random((mb, nb)) < density
    dense = np.where(np.kron(mask, np.ones((u, w), bool)),
                     r.standard_normal((mb * u, nb * w)), 0.0)
    return sp.csc_matrix(dense)


def straddle_pack():
    """A 4x4 tile at rows 1022..1025 crosses the TPU kernel's aligned
    1024-element x boundary (``tests/test_pallas_2d.py:115-135``)."""
    u, w = 4, 4
    dense = np.zeros((2048, 8))
    rng = np.random.default_rng(5)
    dense[1022 : 1022 + u, 0:w] = rng.standard_normal((u, w))
    dense[98 : 98 + u, w : 2 * w] = rng.standard_normal((u, w))
    A = sp.csc_matrix(dense)
    Pi = v.SplitPartition(np.concatenate([[0], np.arange(2, 2048, 4), [2048]]))
    Phi = v.SplitPartition(np.array([0, w, 2 * w]))
    return A, v.pack_vbc2d(v.CSC.from_scipy(A), Pi, Phi, u, w)


def mixed_pack():
    """An explicit row partition of alternating heights 1 and 3: banded
    columns cross several row blocks, so stripes hold tiles of both
    heights."""
    A = banded(300, 160, 6, 40, 4)
    hts = np.tile([1, 3], 75)
    Pi = v.SplitPartition(np.concatenate([[0], np.cumsum(hts)]))
    Phi = v.SplitPartition.equi(160, 4)
    return A, v.pack_vbc2d(v.CSC.from_scipy(A), Pi, Phi, 3, 4)


def rel_err(got, want):
    return np.abs(got - want).max(initial=0.0) / max(
        1e-6, np.abs(want).max(initial=0.0))


def run_both(B2, x, alpha=None, beta=None, y0=None):
    """(JAX tr_spmv_pallas_2d, port tr_spmv_2d) of the same pack; alpha
    and beta are applied to the JAX kernel's output after the call (it
    has none of its own)."""
    bundle = pk2d.pack_stream_vbc2d(B2)
    yj = np.asarray(pk2d.tr_spmv_pallas_2d(bundle, jnp.asarray(x)), np.float64)
    if alpha is not None:
        yj = alpha * yj
    if beta is not None:
        yj = yj + beta * y0
    fmt = vt.VBC2DDevice.from_host(B2, "cpu")
    yt = vt.tr_spmv_2d(fmt, torch.from_numpy(x), alpha, beta,
                       None if beta is None else torch.from_numpy(y0)).numpy()
    assert yt.dtype == np.float32 and yt.shape == (B2.n,)
    return bundle, yj, yt


def check(B2, alpha=None, beta=None):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(B2.m).astype(np.float32)
    y0 = rng.standard_normal(B2.n).astype(np.float32)
    bundle, yj, yt = run_both(B2, x, alpha, beta, y0)
    assert rel_err(yt, yj) <= TOL
    want = B2.tr_mul(x.astype(np.float64), 1.0 if alpha is None else alpha,
                     0.0 if beta is None else beta,
                     None if beta is None else y0.astype(np.float64))
    assert rel_err(yt, want) <= TOL
    return bundle


def test_uniform_tiles_stay_2d(class2_spy):
    A = blocky(40, 30, 3, 4, 0.3, seed=1)
    B2 = v.vbc2d(A, 3, 4, v.AlternatingPacker(v.EquiChunker(4),
                                               v.EquiChunker(3)))
    bundle = check(B2)
    assert bundle.fmt1d is None and not class2_spy
    assert {(c.u, c.w) for c in bundle.classes2d} == {(3, 4)}


def test_mixed_heights_route_through_class2(class2_spy):
    A, B2 = mixed_pack()
    heights = B2.Pi.widths()
    mixed = [l for l in range(B2.L)
             if np.unique(heights[B2.idx[B2.pos[l]:B2.pos[l + 1]]]).size > 1]
    assert mixed
    bundle = check(B2)
    assert bundle.fmt1d is not None and class2_spy


def test_straddling_tile():
    A, B2 = straddle_pack()
    check(B2)


@pytest.mark.parametrize("alpha,beta", [(0.5, None), (2.0, -0.75)])
def test_alpha_beta_y(alpha, beta):
    A = banded(600, 512, 8, 80, seed=2)
    check(v.vbc2d(A, 4, 4), alpha, beta)


def test_corpus_and_rectangle():
    check(v.vbc2d(load_corpus()["HB/west0132"].tocsc(), 4, 4))
    check(v.vbc2d(banded(600, 900, 5, 60, 17), 4, 8))


def test_basis_vectors_exact():
    """One-hot basis vectors reproduce stored tile values exactly through
    the port (every vector) and through the JAX kernel (two per pack: the
    interpret-mode cost)."""
    A = sp.random(24, 30, 0.25, random_state=8, format="csc").astype(np.float32)
    A2, Bm = mixed_pack()
    for B2 in (v.vbc2d(A, 3, 4), Bm):
        D = B2.to_dense().astype(np.float32)
        fmt = vt.VBC2DDevice.from_host(B2, "cpu")
        bundle = pk2d.pack_stream_vbc2d(B2)
        for i in range(B2.m):
            e = np.zeros(B2.m, np.float32)
            e[i] = 1.0
            np.testing.assert_array_equal(
                vt.tr_spmv_2d(fmt, torch.from_numpy(e)).numpy(), D[i])
            if i in (0, B2.m // 2):
                np.testing.assert_array_equal(np.asarray(
                    pk2d.tr_spmv_pallas_2d(bundle, jnp.asarray(e))), D[i])


def test_class2_on_its_1d_route():
    """Row 7's own route: JAX ``tr_spmv_pallas2`` on a multi-class DP pack
    against the port's stripe ``tr_spmv`` on the same pack."""
    A = banded(300, 300, 5, 40, 12)
    B = v.vbc1d(A, 4, v.DynamicTotalChunker(v.model_1dvbc_memory(4, 4), 4))
    assert len(set(B.Phi.widths().tolist())) > 1
    x = np.random.default_rng(3).standard_normal(300).astype(np.float32)
    yj = np.asarray(pk2.tr_spmv_pallas2(pk2.pack_stream2(B), jnp.asarray(x)))
    yt = vt.tr_spmv(vt.VBC1DDevice.from_host(B, "cpu"),
                    torch.from_numpy(x)).numpy()
    assert rel_err(yt, yj) <= TOL
    assert rel_err(yt, A.T.astype(np.float64) @ x) <= TOL


def test_edge_shapes():
    """Empty stripes, empty row blocks, zero-width stripes, n == 0 and
    m == 0 (the plain version; the kernel takes the same packs on the
    card)."""
    D = np.zeros((6, 7), np.float32)
    D[0:2, 0:3] = [[1, 2, 3], [4, 5, 6]]
    D[5, 5:7] = [7, 8]
    A = v.CSC.from_scipy(sp.csc_matrix(D))
    Pi = v.SplitPartition(np.array([0, 2, 2, 5, 6]))  # an empty row block
    Phi = v.SplitPartition(np.array([0, 3, 3, 5, 7]))  # a zero-width stripe
    B2 = v.pack_vbc2d(A, Pi, Phi, 3, 3)
    assert B2.pos[2] == B2.pos[3]  # stripe 2 (columns 3-4) is empty
    fmt = vt.VBC2DDevice.from_host(B2, "cpu")
    x = np.arange(1, 7, dtype=np.float32)
    y0 = np.ones(7, np.float32)
    got = vt.tr_spmv_2d(fmt, torch.from_numpy(x), 2.0, 0.5,
                        torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(got, 2.0 * (D.T @ x) + 0.5, rtol=1e-6)
    for shape in ((5, 0), (0, 4)):
        B0 = vt.vbc2d(sp.csc_matrix(shape, dtype=np.float32), 4, 4)
        f0 = vt.VBC2DDevice.from_host(B0, "cpu")
        got = vt.tr_spmv_2d(f0, torch.ones(shape[0]))
        np.testing.assert_array_equal(got.numpy(), np.zeros(shape[1]))


TILE_PACKS = {
    "uniform": lambda: v.vbc2d(blocky(40, 30, 3, 4, 0.3, seed=1), 3, 4,
                               v.AlternatingPacker(v.EquiChunker(4),
                                                   v.EquiChunker(3))),
    "mixed_heights": lambda: mixed_pack()[1],
    "straddling_tile": lambda: straddle_pack()[1],
    "empty_stripe_and_zero_height_tile": lambda: zero_height_pack(v),
    "rectangle": lambda: v.vbc2d(banded(600, 900, 5, 60, 17), 4, 8),
}


@pytest.mark.parametrize("pack", sorted(TILE_PACKS))
def test_tile_places_match_jax_pack(pack):
    """``tile_row``/``tile_ofs``, built on the device, against the JAX
    package's ``VBC2D``: ``Pi.spl[idx]`` and the running sum of ``u * w``."""
    B2 = TILE_PACKS[pack]()
    fmt = vt.VBC2DDevice.from_host(B2, "cpu")
    u = np.diff(B2.Pi.spl)[B2.idx]
    w = np.repeat(np.diff(B2.Phi.spl), np.diff(B2.pos))
    assert fmt.tile_row.dtype == fmt.tile_ofs.dtype == torch.int32
    np.testing.assert_array_equal(fmt.tile_row.numpy(), B2.Pi.spl[B2.idx])
    np.testing.assert_array_equal(fmt.tile_ofs.numpy(),
                                  np.concatenate([[0], np.cumsum(u * w)]))
    np.testing.assert_array_equal(fmt.tile_ofs.numpy()[B2.pos], B2.ofs)
    assert fmt.nbytes == sum(a.size * 4 for a in (
        B2.Pi.spl, B2.Phi.spl, B2.pos, B2.idx, B2.ofs, B2.val)) + 4 * (
        B2.n + 2 * B2.idx.size + 1)
    if pack == "empty_stripe_and_zero_height_tile":
        assert 0 in u and np.any(np.diff(B2.pos) == 0)
        x = np.arange(1, B2.m + 1, dtype=np.float32)
        got = vt.tr_spmv_2d(fmt, torch.from_numpy(x), 2.0).numpy()
        np.testing.assert_allclose(got, B2.tr_mul(x.astype(np.float64), 2.0),
                                   rtol=1e-6)


@pytest.mark.parametrize("pack", sorted(TILE_PACKS))
def test_lanes_per_stripe(pack):
    """The tile kernel's lane group: a power of two up to a warp that
    covers the mean stripe width, about 16 stored values a lane."""
    from vbcs_tpu_torch.ops.trspmv2d import VALUES_PER_LANE, lanes_per_stripe

    B2 = TILE_PACKS[pack]()
    fmt = vt.VBC2DDevice.from_host(B2, "cpu")
    G = lanes_per_stripe(fmt)
    assert G in (1, 2, 4, 8, 16, 32)
    want = max(1.0, B2.n / B2.L, B2.val.size / (B2.L * VALUES_PER_LANE))
    assert G >= min(32, want) and (G == 1 or G / 2 < want)


def test_from_host_checks():
    A, B2 = mixed_pack()
    fmt = vt.VBC2DDevice.from_host(B2, "cpu")
    assert fmt.val.dtype == torch.float32 and fmt.idx.dtype == torch.int32
    assert (fmt.K, fmt.L) == (B2.K, B2.L) and fmt.col_stripe.numel() == B2.n
    row, col = fmt.value_coords
    D = np.zeros(B2.shape, np.float32)
    D[row.numpy(), col.numpy()] = fmt.val.numpy()
    np.testing.assert_array_equal(D, B2.to_dense().astype(np.float32))

    def bad(**kw):
        fields = dict(m=B2.m, n=B2.n, U=B2.U, W=B2.W, Pi=B2.Pi, Phi=B2.Phi,
                      pos=B2.pos, idx=B2.idx, ofs=B2.ofs, val=B2.val)
        fields.update(kw)
        with pytest.raises(ValueError):
            vt.VBC2DDevice.from_host(vt.VBC2D(**fields), "cpu")

    bad(idx=B2.idx + B2.K)  # row-block id out of range
    bad(idx=np.roll(B2.idx, 1))  # tiles of other heights: ofs disagrees
    bad(ofs=B2.ofs + 1)
    bad(m=B2.m + 1)  # Pi does not cover the rows
    big = vt.VBC2D(m=2**31, n=B2.n, U=2**31, W=B2.W,
                   Pi=vt.SplitPartition(np.concatenate([B2.Pi.spl, [2**31]])),
                   Phi=B2.Phi, pos=B2.pos, idx=B2.idx, ofs=B2.ofs, val=B2.val)
    with pytest.raises(ValueError):
        vt.VBC2DDevice.from_host(big, "cpu")
    with pytest.raises(TypeError):
        vt.tr_spmv_2d(fmt, torch.zeros(B2.m, dtype=torch.float64))
    with pytest.raises(ValueError):
        vt.tr_spmv_2d(fmt, torch.zeros(B2.m - 1))
    with pytest.raises(ValueError):
        vt.tr_spmv_2d(fmt, torch.zeros(B2.m), 1.0, 0.5, torch.zeros(1))
