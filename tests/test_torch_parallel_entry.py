"""The port's ``entry.py`` against ``__graft_entry__.py``, and the map of
counterparts.

``entry()`` on the CPU against the JAX ``entry()`` (the same
``HB__can_292`` pack, the same x from seed 0); ``dryrun_multichip(D,
"cpu", backend="gloo")`` for D in {1, 2, 4} (one world a D for the
module): every path within its tolerance of the f64 product, every rank
of the banded matrix with local stripes, and its first step (TrSpMV and
TrSpMM at k = 8 on ``HB__can_292``, x and X from seed 1 as there)
against the JAX dry-run's first step, ``parallel/spmv.py``'s
``shard_vbc`` + ``dist_tr_spmv``/``dist_tr_spmm`` on the conftest mesh's
first D devices.  Then :data:`vbcs_tpu_torch.parallel.COUNTERPARTS`
names a port function for every public function of the four JAX
``parallel/`` modules and of ``__graft_entry__.py``.

Tolerance: ``|Δ| / max|y| <= 2e-5``.
"""

import importlib
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from vbcs_tpu.formats.device import bin_vbc1d
from vbcs_tpu.parallel import spmv as jdist
from vbcs_tpu_torch import entry
from vbcs_tpu_torch.parallel import COUNTERPARTS

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import __graft_entry__ as graft  # noqa: E402

NDEVS = (1, 2, 4)
TOL = 2e-5
JAX_MODULES = ("vbcs_tpu.parallel.spmv", "vbcs_tpu.parallel.pallas_spmv",
               "vbcs_tpu.parallel.pallas_spmv2d", "vbcs_tpu.parallel.pallas_spmv3")


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def dryruns():
    return {ndev: entry.dryrun_multichip(ndev, "cpu", backend="gloo")
            for ndev in NDEVS}


def test_entry_matches_jax():
    fn, args = entry.entry("cpu")
    got = fn(*args).numpy()
    jfn, jargs = graft.entry()
    want = np.asarray(jfn(*jargs))
    A, _ = entry._flagship()
    assert rel(got, want) <= TOL
    assert rel(got, A.T.astype(np.float64) @ args[1].numpy().astype(np.float64)) <= TOL
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))


@pytest.mark.parametrize("ndev", NDEVS)
def test_dryrun_matches_jax_step(dryruns, ndev):
    got = dryruns[ndev]
    assert set(got) == {"tr_spmv", "tr_spmm", "replicated", "halo", "overlap",
                        "2d", "2d_halo", "stripes"}
    assert all(rec["err"] <= TOL for rec in got.values())
    assert all(s["local"] > 0 for s in got["overlap"]["stats"])
    A, Bj, dev = graft._flagship()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(A.shape[0]), dtype=jnp.float32)
    X = jnp.asarray(rng.standard_normal((A.shape[0], 8)), dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("d",))
    sdev = jdist.shard_vbc(bin_vbc1d(Bj, dtype=np.float32), mesh)
    y, Y = jax.jit(lambda d, x, X: (jdist.dist_tr_spmv(d, x, mesh),
                                    jdist.dist_tr_spmm(d, X, mesh)))(sdev, x, X)
    assert rel(got["tr_spmv"]["y"], y) <= TOL
    assert rel(got["tr_spmm"]["y"], Y) <= TOL


@pytest.mark.parametrize("ndev", NDEVS)
def test_dryrun_shards_cover_each_matrix(dryruns, ndev):
    """Each path's ranks hold every column once between them, and the
    halo paths receive no more tiles than the other ranks own."""
    for path, rec in dryruns[ndev].items():
        assert len(rec["stats"]) == ndev
        assert sum(s["columns"] for s in rec["stats"]) == rec["y"].shape[0]
        for d, s in enumerate(rec["stats"]):
            if "received" in s:
                assert s["received"] <= (ndev - 1) * s["tiles_per_dev"]


@pytest.mark.parametrize("module", JAX_MODULES + ("__graft_entry__",))
def test_every_public_function_has_a_counterpart(module):
    mod = graft if module == "__graft_entry__" else importlib.import_module(module)
    public = [name for name, f in inspect.getmembers(mod, inspect.isfunction)
              if f.__module__ == mod.__name__ and not name.startswith("_")]
    assert public
    for name in public:
        target = COUNTERPARTS[f"{module}.{name}"]
        path, attr = target.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(path), attr)), target
