"""The port's sharding and halo planning (``vbcs_tpu_torch/parallel/shard.py``).

Host NumPy, no ranks: the stripe ranges against the JAX package's
``_split_ranges`` (every boundary carry-free) and ``_shard_ranges``, the
column slices against the host oracle, and the invariants of the halo
and overlap plans: the ranges cover every stripe once, every tile a rank
reads is in its pool once (its rows there read the same x), no rank
sends itself a tile, and on a banded matrix every rank has local
stripes.  Slices and pools are exact (bitwise) rewrites of the pack.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu_torch as vt
from vbcs_tpu.parallel import pallas_spmv as dps
from vbcs_tpu.parallel import pallas_spmv3 as d3
from vbcs_tpu_torch.parallel import shard
from vbcs_tpu_torch.tools.matrices import blocky_matrix

NDEVS = (1, 2, 3, 4, 8)


def banded(m, n, d, band, seed):
    r = np.random.default_rng(seed)
    rows = np.clip((np.arange(n) * m // n)[:, None]
                   + r.integers(-band, band, (n, d)), 0, m - 1)
    return sp.coo_matrix((r.standard_normal(n * d).astype(np.float32),
                          (rows.reshape(-1), np.repeat(np.arange(n), d))),
                         shape=(m, n)).tocsc()


def packs():
    A1 = banded(5000, 3000, 6, 300, 1)
    A2 = banded(3001, 2000, 5, 200, 2)
    return {
        "1d": (A1, vt.vbc1d(A1, 8)),
        "2d": (A2, vt.vbc2d(A2, 3, 4, vt.AlternatingPacker(vt.EquiChunker(4),
                                                           vt.EquiChunker(3)))),
        "2d_default": (A2, vt.vbc2d(A2, 4, 4)),
    }


PACKS = packs()


@pytest.mark.parametrize("ndev", NDEVS)
def test_split_ranges_match_jax(ndev):
    rng = np.random.default_rng(ndev)
    for cost in (rng.integers(0, 50, 333), np.ones(7), np.zeros(5),
                 rng.integers(1, 5, 3)):
        want = dps._split_ranges(cost.size, np.zeros(cost.size, np.int32), ndev,
                                 weight=cost)
        assert shard.split_ranges(cost, ndev) == [tuple(map(int, r)) for r in want]
    for S in (0, 1, 7, 515, 4096):
        assert shard.even_ranges(S, ndev) == d3._shard_ranges(S, ndev)


@pytest.mark.parametrize("kind", sorted(PACKS))
@pytest.mark.parametrize("ndev", NDEVS)
def test_slices_cover_the_pack(kind, ndev):
    """Each stripe in one range, and the slices' products concatenate to
    the whole pack's (exactly: the same values in the same order)."""
    A, B = PACKS[kind]
    S = B.Phi.spl.size - 1
    ranges = shard.split_ranges(shard.stored_per_stripe(B), ndev)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a <= b for a, b in ranges)
    assert all(ranges[d][1] == ranges[d + 1][0] for d in range(ndev - 1))
    cut = shard.shard_2d if kind.startswith("2d") else shard.shard_1d
    x = np.random.default_rng(0).standard_normal(B.m)
    parts = [cut(B, ndev, d, ranges).tr_mul(x) for d in range(ndev)]
    np.testing.assert_array_equal(np.concatenate(parts), B.tr_mul(x))
    with pytest.raises(ValueError):
        cut(B, ndev, 0, ranges[::-1] if ndev > 1 else [(0, S + 1)])


@pytest.mark.parametrize("kind", sorted(PACKS))
@pytest.mark.parametrize("ndev", NDEVS)
def test_halo_plan_invariants(kind, ndev):
    A, B = PACKS[kind]
    halo = shard.plan_halo(B, ndev)
    tpd = halo.tiles_per_dev
    assert tpd == -(-max(1, -(-B.m // 1024)) // ndev)  # the JAX plan's
    dense = A.toarray()
    for d in range(ndev):
        pool = halo.needed[d]
        assert np.array_equal(pool, np.unique(pool))  # sorted, each once
        assert halo.counts[d, d] == 0  # no rank sends itself a tile
        # every tile a row of the slice touches is in the pool
        s0, s1 = shard.split_ranges(shard.stored_per_stripe(B), ndev)[d]
        c0, c1 = B.Phi.spl[s0], B.Phi.spl[s1]
        rows = np.flatnonzero(np.abs(dense[:, c0:c1]).sum(axis=1))
        assert set(rows // 1024) <= set(pool.tolist())
        # the exchange: what each source sends lands where the pool reads it
        stage = [(d, d * tpd + t) for t in range(tpd)] + [
            (s, s * tpd + int(halo.send[s, d, j]))
            for s in range(ndev) for j in range(halo.hmax)]
        for p, t in enumerate(pool):
            src = stage[halo.pool_src(d)[p]]
            assert src[1] == t and (src[0] == d) == (t // tpd == d)
        assert halo.received(d) == sum(int(t) // tpd != d for t in pool)
        assert np.array_equal(halo.to_pool(d, pool * 1024 + 5),
                              np.arange(pool.size) * 1024 + 5)


def test_to_pool_refuses_a_row_outside():
    _, B = PACKS["1d"]
    halo = shard.plan_halo(B, 4)
    outside = np.setdiff1d(np.arange(-(-B.m // 1024)), halo.needed[0])
    with pytest.raises(ValueError):
        halo.to_pool(0, outside[:1] * 1024)


@pytest.mark.parametrize("ndev", (1, 2, 4, 8))
def test_overlap_order_has_local_stripes(ndev):
    """On the dry-run's banded blocky matrix every rank has local
    stripes; the order is a permutation, local first, and a stripe is
    local exactly when its rows lie in the rank's own x tiles."""
    A = blocky_matrix(L=4096, band=400)
    B = vt.vbc1d(A, 8)
    ranges = shard.split_ranges(shard.stored_per_stripe(B), ndev)
    halo = shard.plan_halo(B, ndev, ranges)
    for d, (s0, s1) in enumerate(ranges):
        order, k = shard.plan_overlap(B, halo, d, ranges)
        assert k > 0
        assert np.array_equal(np.sort(order), np.arange(s1 - s0))
        lo, hi = d * halo.tiles_per_dev * 1024, (d + 1) * halo.tiles_per_dev * 1024
        for i, s in enumerate(order):
            rows = B.idx[B.pos[s0 + s]:B.pos[s0 + s + 1]]
            assert (i < k) == bool(((rows >= lo) & (rows < hi)).all())
        assert np.array_equal(order[:k], np.sort(order[:k]))


def test_permute_stripes_moves_columns():
    A, B = PACKS["1d"]
    order = np.random.default_rng(3).permutation(B.Phi.spl.size - 1)
    P = shard.permute_stripes(B, order)
    cols = shard.stripe_columns(B, order)
    x = np.random.default_rng(4).standard_normal(B.m)
    np.testing.assert_array_equal(P.tr_mul(x), B.tr_mul(x)[cols])
    assert np.array_equal(np.sort(cols), np.arange(B.n))
