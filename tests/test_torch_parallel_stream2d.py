"""The port's 2-D paths (``parallel/stream.py`` on a ``VBC2D``) against
``vbcs_tpu/parallel/pallas_spmv2d.py``.

The same host ``VBC2D`` goes through the JAX chunk-sharded u-blocked
paths (``shard_stream_2d`` + ``place_2d``, then ``dist_tr_spmv_pallas_2d``
and, with ``plan_halo_2d``, ``dist_tr_spmv_pallas_2d_halo``; Pallas in
interpret mode under ``jax.jit`` on the conftest mesh's first D devices)
and through the port's 2-D replicated and halo paths on a world of D
gloo ranks on the CPU (one world a D for the module), D in {1, 2, 4}:

* ``equi``: the banded matrix of exact 3 x 4 tiles of
  ``tests/test_dist_pallas_2d.py``;
* ``straddle``: four 4 x 4 tiles, each across an aligned 1,024-row
  boundary which at D = 4 is a boundary between two ranks' x tiles, both
  halves read from other ranks by three of the four stripes
  (``chip_smoke.straddle_ranks_pack``);
* ``fallback``: the default planner on the random matrix of
  ``test_mixed_height_fallback_raises``, which the JAX pack sends to its
  1-D fallback, and ``mixed``: alternating tile heights 1 and 3 in every
  stripe (``chip_smoke.mixed_height_pack``).  The JAX sharded path
  raises ``NotImplementedError`` on both (its 1-D fallback is not
  wired); the port's tile kernel takes any height, so its result is held
  against the f64 product and the host oracle.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX result, the f64
product and the host oracle ``VBC2D.tr_mul``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import pallas_trspmv2d as pk2d
from vbcs_tpu.ops import windowed_gather as wg
from vbcs_tpu.parallel import pallas_spmv2d as dps2
from vbcs_tpu_torch import entry
from vbcs_tpu_torch.parallel import comm, shard

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (mixed_height_pack, mixed_stripes,  # noqa: E402
                        straddle_ranks_pack)

NDEVS = (1, 2, 4)
PATHS = ("2d", "2d_halo")
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pk2, pk2d, wg):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    yield


def blocky2d(K, u, w, d, band, seed):
    """Banded matrix of exact u x w dense tiles."""
    rng = np.random.default_rng(seed)
    rb = np.clip(np.arange(K)[:, None] + rng.integers(-band, band, (K, d)), 0, K - 1)
    rows = np.repeat(rb.reshape(-1)[:, None] * u + np.arange(u)[None, :], w,
                     axis=0).reshape(-1)
    cols = np.repeat(np.repeat(np.arange(K) * w, d), u)[:, None] + np.arange(w)[None, :]
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols.reshape(-1))), shape=(K * u, K * w)).tocsc()
    A.sum_duplicates()
    return A


def jax_pack(B):
    """The JAX package's ``VBC2D`` of the same arrays."""
    return v.VBC2D(m=B.m, n=B.n, U=B.U, W=B.W, Pi=v.SplitPartition(B.Pi.spl),
                   Phi=v.SplitPartition(B.Phi.spl), pos=B.pos, idx=B.idx,
                   ofs=B.ofs, val=B.val)


def cases():
    """name -> (port VBC2D, x)."""
    A = blocky2d(900, 3, 4, 5, 120, 1)
    equi = vt.vbc2d(A, 3, 4, vt.AlternatingPacker(vt.EquiChunker(4), vt.EquiChunker(3)))
    fallback = vt.vbc2d(sp.random(700, 500, 0.01, random_state=4, format="csc"), 3, 4)
    out = {}
    for i, (name, B) in enumerate((("equi", equi), ("straddle", straddle_ranks_pack()),
                                   ("fallback", fallback),
                                   ("mixed", mixed_height_pack()))):
        out[name] = (B, np.random.default_rng(i).standard_normal(B.m).astype(np.float32))
    return out


CASES = cases()
JOBS = [(case, path, {"path": path, "B": CASES[case][0], "x": CASES[case][1]})
        for case in sorted(CASES) for path in PATHS]


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for ndev in NDEVS:
        ranks = comm.run_ranks(entry.rank_paths, ndev, "gloo", "cpu",
                               [job for _, _, job in JOBS])
        out[ndev] = [{(case, path): rec for (case, path, _), rec in zip(JOBS, r)}
                     for r in ranks]
    return out


def jax_result(case, path, ndev):
    B, x = CASES[case]
    bundle = pk2d.pack_stream_vbc2d(jax_pack(B))
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("d",))
    s0 = dps2.shard_stream_2d(bundle, ndev)
    s = dps2.place_2d(s0, mesh)
    xj = jnp.asarray(x)
    if path == "2d":
        return np.asarray(jax.jit(
            lambda s, xx: dps2.dist_tr_spmv_pallas_2d(s, xx, mesh))(s, xj))
    halo = dps2.plan_halo_2d(s0)
    return np.asarray(jax.jit(
        lambda s, h, xx: dps2.dist_tr_spmv_pallas_2d_halo(s, h, xx, mesh))(s, halo, xj))


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_path_matches_jax(worlds, case, path, ndev):
    B, x = CASES[case]
    got = worlds[ndev][0][(case, path)]["y"]
    want = sp.csc_matrix(B.to_dense()).T.astype(np.float64) @ x.astype(np.float64)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel(got, want) <= TOL
    assert rel(got, B.tr_mul(x.astype(np.float64))) <= TOL
    if case in ("fallback", "mixed"):
        with pytest.raises(NotImplementedError):
            jax_result(case, path, ndev)
    else:
        assert rel(got, jax_result(case, path, ndev).astype(np.float64)) <= TOL


@pytest.mark.parametrize("case", ("fallback", "mixed"))
def test_jax_packs_take_the_fallback(case):
    """Both packs go to the JAX 1-D fallback (which its sharded path
    refuses); the ``mixed`` one has stripes of tiles of two heights."""
    B, _ = CASES[case]
    assert pk2d.pack_stream_vbc2d(jax_pack(B)).fmt1d is not None
    assert (mixed_stripes(B) > 0) == (case == "mixed")


def test_straddle_reads_two_other_ranks(worlds):
    """At D = 4 each straddling tile's two x tiles belong to two ranks, and
    rank 0 (whose tile crosses from rank 2's x into rank 3's) receives
    both halves."""
    B, _ = CASES["straddle"]
    halo = shard.plan_halo(B, 4)
    assert halo.tiles_per_dev == 1
    assert list(halo.needed[0]) == [2, 3] and halo.received(0) == 2
    rec = worlds[4][0][("straddle", "2d_halo")]["stats"]
    assert rec["received"] == 2 and rec["columns"] == 4


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_path_holds_its_kernels(worlds, case, path, ndev):
    """Every rank holds the kernels its path runs against their plain
    versions on the path's own inputs (equal on the CPU): the tile kernel,
    and on the halo path the tile copy (the tiles sent and the pool)."""
    want = {"tr_spmv_2d"} if path == "2d" else {"tr_spmv_2d", "gather_tiles"}
    for rank in worlds[ndev]:
        plain = rank[(case, path)]["plain"]
        assert set(plain) == want
        assert all(diff == 0.0 for diff, _ in plain.values())
