"""The port's ``parallel/stream.py`` against ``vbcs_tpu/parallel/pallas_spmv.py``.

The same host pack goes through the JAX chunk-sharded stream paths
(``shard_stream`` + ``place``, then ``dist_tr_spmv_pallas``,
``dist_tr_spmv_pallas_halo`` with ``plan_halo``, and
``dist_tr_spmv_pallas_halo_overlap`` with ``plan_overlap``; Pallas in
interpret mode, under ``jax.jit``, on the conftest mesh's first D
devices) and through the port's replicated, halo and overlapped-halo
paths on a world of D gloo ranks on the CPU (one world a D for the
module), D in {1, 2, 4}: the banded matrix of ``tests/test_dist_pallas.py``
and a scattered one, whose JAX pack sends its classes to the v1
fallback and whose port shards read every x tile (the halo is then the
whole of x: no fallback class needed).

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX result and the f64
product.  The three port paths run the same stripes on the same x
values, so their results are bitwise equal to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv as pk1
from vbcs_tpu.ops import pallas_trspmv2 as pk2
from vbcs_tpu.ops import windowed_gather as wg
from vbcs_tpu.parallel import pallas_spmv as dps
from vbcs_tpu_torch import entry
from vbcs_tpu_torch.parallel import comm, shard, stream

NDEVS = (1, 2, 4)
PATHS = ("replicated", "halo", "overlap")
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    for mod in (pk1, pk2, wg):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    yield


def banded(m, n, d, band, seed):
    r = np.random.default_rng(seed)
    rows = np.clip((np.arange(n) * m // n)[:, None] + r.integers(-band, band, (n, d)),
                   0, m - 1)
    return sp.coo_matrix((r.standard_normal(n * d), (rows.reshape(-1),
                                                     np.repeat(np.arange(n), d))),
                         shape=(m, n)).tocsc()


def cases():
    """name -> (A, port pack, JAX pack, x)."""
    A1 = banded(4000, 4096, 6, 300, 1)
    A2 = sp.random(6000, 512, 0.005, random_state=7, format="csc")
    out = {}
    for name, A, W, w in (("banded", A1, 8, 4), ("scattered", A2, 4, 2)):
        x = np.random.default_rng(3).standard_normal(A.shape[0]).astype(np.float32)
        out[name] = (A, vt.vbc1d(A, W, vt.EquiChunker(w)),
                     v.vbc1d(A, W, v.EquiChunker(w)), x)
    return out


CASES = cases()
JOBS = [(case, path, {"path": path, "B": CASES[case][1], "x": CASES[case][3]})
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
    _, _, Bj, x = CASES[case]
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("d",))
    s0 = dps.shard_stream(pk2.pack_stream2(Bj), ndev)
    xj = jnp.asarray(x)
    if path == "replicated":
        s = dps.place(s0, mesh)
        return np.asarray(jax.jit(
            lambda s, xx: dps.dist_tr_spmv_pallas(s, xx, mesh))(s, xj))
    if path == "halo":
        halo = dps.plan_halo(s0)
        s = dps.place(s0, mesh)
        return np.asarray(jax.jit(
            lambda s, h, xx: dps.dist_tr_spmv_pallas_halo(s, h, xx, mesh))(s, halo, xj))
    s1, k_locals = dps.plan_overlap(s0)
    halo = dps.plan_halo(s1)
    s = dps.place(s1, mesh)
    return np.asarray(jax.jit(
        lambda s, h, xx: dps.dist_tr_spmv_pallas_halo_overlap(s, h, k_locals, xx, mesh)
    )(s, halo, xj))


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_path_matches_jax(worlds, case, path, ndev):
    A, _, _, x = CASES[case]
    got = worlds[ndev][0][(case, path)]["y"]
    want = A.T.astype(np.float64) @ x.astype(np.float64)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel(got, want) <= TOL
    assert rel(got, jax_result(case, path, ndev).astype(np.float64)) <= TOL
    np.testing.assert_array_equal(got, worlds[ndev][0][(case, "replicated")]["y"])


@pytest.mark.parametrize("ndev", NDEVS)
def test_halo_sizes(worlds, ndev):
    """The banded matrix's halo is a sliver of x on every rank, and every
    rank has local stripes; the scattered one's is the rest of x."""
    for d, rank in enumerate(worlds[ndev]):
        band = rank[("banded", "overlap")]["stats"]
        assert band["hmax"] < band["tiles_per_dev"] + 2 and band["received"] <= 2
        assert band["local"] > 0
        scat = rank[("scattered", "halo")]["stats"]
        tiles = -(-CASES["scattered"][0].shape[0] // 1024)
        own = min(scat["tiles_per_dev"],
                  max(0, tiles - scat["tiles_per_dev"] * d))
        assert scat["received"] == tiles - own


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_path_holds_its_kernels(worlds, case, path, ndev):
    """Every rank holds the kernels its path runs against their plain
    versions on the path's own inputs (equal on the CPU, where a wrapper
    runs its plain version): the stripe kernel, and on the halo paths the
    tile copy of the tiles sent (the stripe kernel reads the stage, and
    the overlap's two launches write y in column order: no gather)."""
    want = {"tr_spmv"} if path == "replicated" else {"tr_spmv", "gather_tiles"}
    for rank in worlds[ndev]:
        plain = rank[(case, path)]["plain"]
        assert set(plain) == want
        assert all(diff == 0.0 for diff, _ in plain.values())


def shards(B, ndev):
    ranges = shard.split_ranges(shard.stored_per_stripe(B), ndev)
    return [stream.StreamShard(rank=d, ndev=ndev, pack=B, ranges=ranges,
                               device=torch.device("cpu")) for d in range(ndev)]


def triples(fmt, x) -> set:
    """(row, column, value) of every stored value of ``fmt``, its rows
    read through ``x`` (which holds each row's global index) and its
    columns at their output places."""
    row, col = fmt.value_coords
    return set(zip(x[row].long().tolist(), col.tolist(), fmt.val.tolist()))


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_maps_move_tiles_and_columns(case, ndev):
    """The halo paths' maps, with the exchange done by hand on an x that
    holds its own indices (so the comparisons are exact): the tile copy of
    each rank's send list fills every stage so that the halo format's
    block rows (stage coordinates) read the rows of the slice, the 2-D
    path's pool copy gives x at the tiles the rank reads in global tile
    order, and the overlap's two formats read their rows from the rank's
    own tiles and its stage and put every column of the slice at its
    place in it once (``col_out``)."""
    B = CASES[case][1]
    shs = shards(B, ndev)
    halo = shs[0].halo
    x = torch.arange(B.m, dtype=torch.float32)
    x_own = [stream.own_x(sh, x) for sh in shs]
    sent = [vt.gather_tiles(xo, sh.send_tiles).view(ndev, -1)
            for sh, xo in zip(shs, x_own)]
    x_pad = torch.zeros(ndev * halo.tiles_per_dev * shard.TILE)
    x_pad[:B.m] = x
    for d, sh in enumerate(shs):
        stage = torch.cat([x_own[d]] + [sent[s][d] for s in range(ndev)])
        assert stage.numel() == halo.stage_rows
        pool = vt.gather_tiles(stage, sh.pool_tiles).view(-1, shard.TILE)
        assert pool.shape[0] == halo.needed[d].size
        want = x_pad.view(-1, shard.TILE)[torch.from_numpy(halo.needed[d])]
        assert torch.equal(pool, want)
        slice_ = triples(sh.fmt, x)
        assert triples(sh.halo_fmt, stage) == slice_
        local, rest = sh.overlap_fmts
        assert triples(local, x_own[d]) | triples(rest, stage) == slice_
        places = torch.cat([local.col_out, rest.col_out])
        assert torch.equal(places.sort().values, torch.arange(sh.host.n, dtype=torch.int32))
        y = torch.full((sh.host.n,), -1.0)
        vt.tr_spmv(local, x_own[d], out=y)
        vt.tr_spmv(rest, stage, out=y)
        assert torch.equal(y, vt.tr_spmv(sh.fmt, x))


def test_shard_stream_refuses_an_unknown_balance():
    """``balance`` is ``"stored"`` or ``"even"`` (the column-stripe path's
    near-equal stripe counts), nothing else."""
    with pytest.raises(ValueError, match="balance"):
        stream.shard_stream(CASES["banded"][1], device="cpu", balance="rows")
