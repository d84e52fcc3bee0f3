"""The port's column-stripe path against ``vbcs_tpu/parallel/pallas_spmv3.py``.

The same host ``VBC1D`` goes through the JAX column-stripe one-shot
(``shard_oneshot3`` + ``place3``, then ``dist_tr_spmv_oneshot3``; Pallas in
interpret mode under ``jax.jit`` on the conftest mesh's first D devices)
and through the port's ``shard_stream(..., balance="even")`` +
``dist_tr_spmv_replicated`` (the ``"stripes"`` path of ``entry.PATHS``) on a
world of D gloo ranks on the CPU (one world a D for the module), D in
{1, 2, 4}, with alpha None and 0.5: the blocky matrix of
``tests/test_dist_pallas_v3.py`` (512 stripes), 515 stripes (not a
multiple of D) and the multi-class plan of alternating widths 8 and 4
(``test_dist_pallas_v3.py:79,103``).  Where the JAX version refuses a
shard (``shard_oneshot3`` returns None: the shards' class signatures
differ), the port is held against the f64 product alone; it refuses
nothing.

Tolerance: ``|Δ| / max|y| <= 2e-5`` against the JAX result and the f64
product; the ranks' stripe counts differ by at most one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv3 as pk3
from vbcs_tpu.ops import windowed_gather as wgm
from vbcs_tpu.parallel import pallas_spmv3 as d3
from vbcs_tpu_torch import entry
from vbcs_tpu_torch.parallel import comm

NDEVS = (1, 2, 4)
ALPHAS = (None, 0.5)
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(pk3.pl, "pallas_call", patched)
    monkeypatch.setattr(wgm.pl, "pallas_call", patched)
    yield


def blocky(L, d, band, seed):
    rng = np.random.default_rng(seed)
    m = L * 8
    cs = np.arange(L) * 8 + 4
    rr = np.clip(cs[:, None] + rng.integers(-band, band, (L, d)), 0, m - 1)
    rows = np.repeat(rr.reshape(-1), 8)
    cols = (np.repeat(np.arange(L) * 8, d)[:, None] + np.arange(8)[None, :]).reshape(-1)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, m)).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return A


def two_widths(S, seed=7):
    rng = np.random.default_rng(seed)
    widths = np.where(np.arange(S) % 2 == 0, 8, 4)
    spl = np.concatenate([[0], np.cumsum(widths)])
    n = int(spl[-1])
    rr = np.clip(spl[:-1, None] + rng.integers(-40, 40, (S, 5)), 0, n - 1)
    rows = np.repeat(rr, widths, axis=0).reshape(-1)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, np.repeat(np.arange(n), 5))), shape=(n, n)).tocsc()
    A.sum_duplicates()
    return A, spl


def cases():
    """name -> (A, port pack, JAX pack, x)."""
    out = {}
    for name, A in (("blocky512", blocky(512, 6, 60, 1)),
                    ("nondivisible515", blocky(515, 6, 60, 4))):
        out[name] = (A, vt.vbc1d(vt.CSC.from_scipy(A), 8, vt.EquiChunker(8)),
                     v.vbc1d(v.CSC.from_scipy(A), 8, v.EquiChunker(8)))
    A, spl = two_widths(2048)
    out["multiclass"] = (A, vt.vbc1d(vt.CSC.from_scipy(A), 8, vt.SplitPartition(spl)),
                         v.vbc1d(v.CSC.from_scipy(A), 8, v.SplitPartition(spl)))
    return {k: (*t, np.random.default_rng(0).standard_normal(t[0].shape[0])
                .astype(np.float32)) for k, t in out.items()}


CASES = cases()
JOBS = [(case, alpha, {"path": "stripes", "B": CASES[case][1], "x": CASES[case][3],
                       "options": {"alpha": alpha}})
        for case in sorted(CASES) for alpha in ALPHAS]


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for ndev in NDEVS:
        ranks = comm.run_ranks(entry.rank_paths, ndev, "gloo", "cpu",
                               [job for _, _, job in JOBS])
        out[ndev] = [{(case, alpha): rec for (case, alpha, _), rec in zip(JOBS, r)}
                     for r in ranks]
    return out


def jax_result(case, ndev, alpha):
    """The JAX one-shot's y, or None where ``shard_oneshot3`` refuses."""
    _, _, Bj, x = CASES[case]
    sfmt = d3.shard_oneshot3(Bj, ndev)
    if sfmt is None:
        return None
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("d",))
    sfmt = d3.place3(sfmt, mesh)
    return np.asarray(jax.jit(
        lambda s, xx: d3.dist_tr_spmv_oneshot3(s, xx, mesh, alpha=alpha)
    )(sfmt, jnp.asarray(x)))


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stripes_match_jax(worlds, case, alpha, ndev):
    A, _, _, x = CASES[case]
    got = worlds[ndev][0][(case, alpha)]["y"]
    want = (1.0 if alpha is None else alpha) * (
        A.T.astype(np.float64) @ x.astype(np.float64))
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel(got, want) <= TOL
    jx = jax_result(case, ndev, alpha)
    if jx is not None:
        assert rel(got, jx.astype(np.float64)) <= TOL
    widths = [r[(case, alpha)]["stats"]["columns"] for r in worlds[ndev]]
    assert sum(widths) == A.shape[1]


@pytest.mark.parametrize("ndev", NDEVS)
def test_stripe_counts_near_equal(ndev):
    """``even_ranges``: 515 stripes over D ranks, sizes within one."""
    from vbcs_tpu_torch.parallel import shard

    sizes = [b - a for a, b in shard.even_ranges(515, ndev)]
    assert sum(sizes) == 515 and max(sizes) - min(sizes) <= 1
    B = CASES["multiclass"][1]
    assert set(np.diff(B.Phi.spl).tolist()) == {4, 8}  # a multi-class plan


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stripes_hold_the_stripe_kernel(worlds, case, ndev):
    """Rank 0 holds the stripe kernel, the path's one kernel, against its
    plain version on the path's own inputs (equal on the CPU)."""
    for alpha in ALPHAS:
        plain = worlds[ndev][0][(case, alpha)]["plain"]
        assert set(plain) == {"tr_spmv"} and plain["tr_spmv"][0] == 0.0
