"""The port's static gather (``ops/gather.py``) against the JAX permutes.

The JAX package applies a static map through windowed Pallas kernels:
``windowed_gather.apply_permute`` on a ``pack_permute`` plan (Clos or
ladder routed, optionally masked) and ``multipass.apply_multipass`` for
maps the single-pass router refuses.  Both run here in interpret mode on
the same inputs as the port's ``gather``.  A gather moves values without
arithmetic, so the results must be bitwise equal.  The tile copy
(``gather_tiles``, the halo paths' map of whole 1,024-element tiles) is
held bitwise to the element gather on the halo plans' own tile lists.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu.ops import multipass as mp
from vbcs_tpu.ops import windowed_gather as wg


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(wg.pl, "pallas_call", patched)
    yield


def local_perm(n, spread, seed):
    """A permutation that moves each element at most ~spread places."""
    rng = np.random.default_rng(seed)
    return np.argsort(np.arange(n) + rng.integers(-spread, spread, n),
                      kind="stable")


def port_gather(src, g, mask=None):
    return vt.gather(
        torch.from_numpy(src), torch.from_numpy(g.astype(np.int32)),
        None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_gather_matches_windowed_permute(masked):
    n = 6000
    rng = np.random.default_rng(3)
    perm = local_perm(n, 200, seed=4)
    mask = rng.random(n) > 0.3 if masked else None
    plan = wg.pack_permute(perm, n, mask=mask)
    assert plan is not None
    src = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(wg.apply_permute(plan, jnp.asarray(src)))
    got = port_gather(src, perm, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.where(mask, src[perm], 0) if masked else src[perm])


@pytest.mark.parametrize("case", ["permutation", "dup_gather_masked"])
def test_gather_matches_multipass(case):
    rng = np.random.default_rng(5)
    if case == "permutation":
        n = src_len = 12000
        g = rng.permutation(n)
        mask = None
    else:
        n, src_len = 9000, 20000
        g = rng.integers(0, src_len, n)
        mask = rng.random(n) > 0.1
    plan = mp.pack_multipass(g, src_len, mask=mask)
    assert plan is not None and plan.n_pass > 1
    src = rng.standard_normal(src_len).astype(np.float32)
    want = np.asarray(mp.apply_multipass(plan, jnp.asarray(src)))[:n]
    np.testing.assert_array_equal(port_gather(src, g, mask), want)


def test_gather_checks():
    src = torch.arange(8, dtype=torch.float32)
    perm = torch.tensor([7, 0, 3], dtype=torch.int32)
    np.testing.assert_array_equal(vt.gather(src, perm).numpy(), [7, 0, 3])
    np.testing.assert_array_equal(
        vt.gather(src, perm, torch.tensor([True, False, True])).numpy(),
        [7, 0, 3])
    assert vt.gather(src, perm[:0]).shape == (0,)
    with pytest.raises(TypeError):
        vt.gather(src, perm.long())
    with pytest.raises(TypeError):
        vt.gather(src.double(), perm)
    with pytest.raises(ValueError):
        vt.gather(src, perm, torch.ones(2, dtype=torch.bool))


def tile_elements(tiles):
    """The element map of whole tiles ``tiles``, tile by tile."""
    tiles = np.asarray(tiles, dtype=np.int64)
    return (tiles[:, None] * vt.ops.gather.TILE
            + np.arange(vt.ops.gather.TILE)[None, :]).reshape(-1)


def halo_tile_lists():
    """The tile lists of the halo paths on a banded 1-D pack of 9,000 rows
    at 4 ranks: each rank's send list (``hmax`` a destination, padded with
    tile 0) and its pool's places in its stage."""
    from vbcs_tpu_torch.parallel import shard

    rng = np.random.default_rng(2)
    n = 9000
    rows = np.clip(np.arange(n)[:, None] + rng.integers(-1500, 1500, (n, 4)), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(4 * n), (rows.reshape(-1),
                                                     np.repeat(np.arange(n), 4))),
                      shape=(n, n)).tocsc()
    halo = shard.plan_halo(vt.vbc1d(A, 8), 4)
    own = halo.tiles_per_dev * vt.ops.gather.TILE
    stage = (halo.tiles_per_dev + 4 * halo.hmax) * vt.ops.gather.TILE
    out = []
    for d in range(4):
        assert (halo.counts[d] < halo.hmax).any()  # padding tiles are sent
        out.append((own, halo.send[d].reshape(-1)))
        out.append((stage, halo.pool_src(d)))
    return out


@pytest.mark.parametrize("which", range(8))
def test_gather_tiles_matches_element_gather(which):
    """The tile copy's plain version is the element gather on the tiles'
    element maps, bitwise, on each halo tile list (padding tiles
    included)."""
    size, tiles = halo_tile_lists()[which]
    src = np.random.default_rng(which).standard_normal(size).astype(np.float32)
    t = torch.from_numpy(np.asarray(tiles, dtype=np.int32))
    got = vt.gather_tiles(torch.from_numpy(src), t)
    assert got.shape == (tiles.size * vt.ops.gather.TILE,)
    np.testing.assert_array_equal(got.numpy(), port_gather(src, tile_elements(tiles)))
    np.testing.assert_array_equal(got.numpy(),
                                  vt.gather_tiles_plain(torch.from_numpy(src), t).numpy())


def test_gather_tiles_checks():
    src = torch.arange(3 * 1024, dtype=torch.float32)
    tiles = torch.tensor([2, 0], dtype=torch.int32)
    assert torch.equal(vt.gather_tiles(src, tiles)[:2], torch.tensor([2048.0, 2049.0]))
    assert vt.gather_tiles(src, tiles[:0]).shape == (0,)
    with pytest.raises(TypeError):
        vt.gather_tiles(src, tiles.long())
    with pytest.raises(TypeError):
        vt.gather_tiles(src.double(), tiles)
    with pytest.raises(ValueError, match="multiple of 1024"):
        vt.gather_tiles(src[:1000], tiles)
    with pytest.raises(ValueError, match="contiguous"):
        vt.gather_tiles(src, tiles.repeat(2)[::2])
