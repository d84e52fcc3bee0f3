"""The port's ``parallel/spmv.py`` against ``vbcs_tpu/parallel/spmv.py``.

The same host packs (a 1-D f32 pack, a 2-D f32 pack under an equi plan,
a 1-D f64 pack) and the same x and X (NumPy, from seeds) go through the
JAX ``shard_vbc`` + ``dist_tr_spmv``/``dist_spmv``/``dist_tr_spmm``/
``dist_spmm`` on the conftest mesh's first D devices and through the
port's counterparts on a world of D gloo ranks on the CPU (one world a
D for the whole module, ``comm.run_ranks``), D in {1, 2, 4}.  On the CPU
the port's kernel wrappers run their plain versions.

Tolerance: ``|Δ| / max|y| <= 2e-5`` for f32 against the JAX result and
the f64 product (sums in other orders: stripe slices here, block slices
and a ``psum`` there); f64 within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import vbcs_tpu as v
import vbcs_tpu_torch as vt
from vbcs_tpu.formats.device import bin_vbc1d, bin_vbc2d
from vbcs_tpu.parallel import spmv as jdist
from vbcs_tpu_torch import entry
from vbcs_tpu_torch.parallel import comm

NDEVS = (1, 2, 4)
CALLS = ("tr_spmv", "spmv", "tr_spmm", "spmm")
TOLS = {"f32": 2e-5, "f64": 1e-12}


def banded(m, n, d, band, seed, dtype):
    r = np.random.default_rng(seed)
    rows = np.clip((np.arange(n) * m // n)[:, None]
                   + r.integers(-band, band, (n, d)), 0, m - 1)
    return sp.coo_matrix((r.standard_normal(n * d).astype(dtype),
                          (rows.reshape(-1), np.repeat(np.arange(n), d))),
                         shape=(m, n)).tocsc()


def cases():
    """name -> (A, port pack, JAX pack, dtype)."""
    A1 = banded(3000, 4000, 6, 300, 1, np.float32)
    A2 = banded(2400, 3000, 5, 200, 2, np.float32)
    A3 = banded(2000, 1500, 4, 150, 3, np.float64)
    eq = (lambda pkg: pkg.AlternatingPacker(pkg.EquiChunker(4), pkg.EquiChunker(3)))
    return {
        "1d_f32": (A1, vt.vbc1d(A1, 8), v.vbc1d(A1, 8), np.float32),
        "2d_f32": (A2, vt.vbc2d(A2, 3, 4, eq(vt)), v.vbc2d(A2, 3, 4, eq(v)),
                   np.float32),
        "1d_f64": (A3, vt.vbc1d(A3, 8), v.vbc1d(A3, 8), np.float64),
    }


CASES = cases()


def operands(A, dtype):
    rng = np.random.default_rng(11)
    m, n = A.shape
    return {"tr_spmv": rng.standard_normal(m).astype(dtype),
            "spmv": rng.standard_normal(n).astype(dtype),
            "tr_spmm": rng.standard_normal((m, 5)).astype(dtype),
            "spmm": rng.standard_normal((n, 3)).astype(dtype)}


JOBS = [(case, call, {"path": call, "B": CASES[case][1],
                      "x": operands(CASES[case][0], CASES[case][3])[call]})
        for case in sorted(CASES) for call in CALLS]


@pytest.fixture(scope="module")
def worlds():
    """Rank 0's records of every job, one gloo world a D."""
    out = {}
    for ndev in NDEVS:
        ranks = comm.run_ranks(entry.rank_paths, ndev, "gloo", "cpu",
                               [job for _, _, job in JOBS])
        out[ndev] = {(case, call): rec for (case, call, _), rec
                     in zip(JOBS, ranks[0])}
    return out


def jax_result(case, call, ndev, x):
    _, _, Bj, dtype = CASES[case]
    binned = (bin_vbc2d if hasattr(Bj, "Pi") else bin_vbc1d)(Bj, dtype=dtype)
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("d",))
    sdev = jdist.shard_vbc(binned, mesh)
    fn = {"tr_spmv": jdist.dist_tr_spmv, "spmv": jdist.dist_spmv,
          "tr_spmm": jdist.dist_tr_spmm, "spmm": jdist.dist_spmm}[call]
    return np.asarray(jax.jit(lambda s, xx: fn(s, xx, mesh))(sdev, jnp.asarray(x)))


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dist_call_matches_jax(worlds, case, call, ndev):
    A, _, _, dtype = CASES[case]
    x = operands(A, dtype)[call]
    got = worlds[ndev][(case, call)]["y"]
    A64 = A.astype(np.float64)
    want = (A64.T if call.startswith("tr_") else A64) @ x.astype(np.float64)
    jx = jax_result(case, call, ndev, x)
    assert got.shape == want.shape == jx.shape and got.dtype == dtype
    tol = TOLS[case[-3:]]
    assert rel(got, want) <= tol
    assert rel(got, jx.astype(np.float64)) <= tol
    # each rank's slice, one after another, covers the columns once
    stats = worlds[ndev][(case, call)]["stats"]
    assert stats["columns"] <= A.shape[1]


def test_a_world_reports_a_failing_rank():
    """A rank that raises stops the world; the caller gets its traceback
    (here ``dryrun_multichip(rank, world, device)`` lacks its backend)."""
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2.*TypeError"):
        comm.run_ranks(entry.dryrun_multichip, 2, "gloo", "cpu")


def test_backend_is_the_callers():
    with pytest.raises(ValueError, match="gloo"):
        comm.run_ranks(entry.rank_paths, 1, "nccl", "cpu", [])
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        comm.run_ranks(entry.rank_paths, 2, "nccl", "cuda:0", [])
    with pytest.raises(ValueError, match="backend"):
        comm.run_ranks(entry.rank_paths, 1, "mpi", "cpu", [])


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dist_call_holds_its_kernel(worlds, case, call, ndev):
    """Rank 0 holds the kernel its call runs against the kernel's plain
    version on the same inputs (equal on the CPU, where the wrapper runs
    the plain version): the slice's TrSpMV route or the SpMM for f32, none
    for the forward products and the semiring route."""
    plain = worlds[ndev][(case, call)]["plain"]
    if case.endswith("f64") or call in ("spmv", "spmm"):
        assert plain == {}
    elif call == "tr_spmm":
        assert set(plain) == {"tr_spmm"}
    else:
        assert len(plain) == 1 and set(plain) <= {"tr_spmv", "tr_spmv_scatter",
                                                  "tr_spmv_2d"}
    assert all(diff == 0.0 for diff, _ in plain.values())
