"""Entry points: one step on the flagship pack, and the distributed dry-run.

Counterpart of ``__graft_entry__.py`` at the repository root:

* :func:`entry` returns ``(fn, args)``, the TrSpMV the operator routes
  the ``HB__can_292`` pack to (``_flagship``), ready to call on ``device``;
* :func:`dryrun_multichip` starts ``n`` ranks (``parallel.comm.run_ranks``)
  and runs one step of every distributed path, each checked against the
  f64 host product: ``parallel/spmv.py``'s TrSpMV and TrSpMM (k = 8) on
  ``HB__can_292``; the replicated, halo and overlapped-halo paths of
  ``parallel/stream.py`` on a banded blocky matrix (``tools.matrices.
  blocky_matrix`` at L = 4,096, rows within +-400 of the diagonal, so
  every rank has stripes whose rows lie in its own x tiles: the JAX
  dry-run's ``HB__can_292`` has 292 rows, one x tile, and left the
  overlap nothing to overlap); the replicated and halo paths on a 2-D
  pack, a banded matrix of dense 3 x 4 tiles, some straddling x tiles;
  and the column-stripe path (the replicated path on near-equal stripe
  runs) on a plan of alternating widths 8 and 4.

``python -m vbcs_tpu_torch.entry`` runs ``dryrun_multichip(4,
backend="gloo")`` on the card (every rank on card ``r`` modulo the
cards: on one card, four ranks share it, which NCCL refuses).

:func:`rank_paths` is the rank's side of the dry-run, also what
``chip_smoke.py`` and the tests start: it runs a list of jobs (a path,
a host pack, x) and returns each job's ``y`` on rank 0, the launches of
each kernel, the rank's shard statistics and, on the card, each kernel
of the path held against its plain version on the path's own inputs
and, when asked, the host wall of each path and the device time of its
kernels.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from .api import vbc1d, vbc2d
from .formats.partition import SplitPartition
from .operator import route_tr_spmv
from .ops.gather import gather, gather_plain, gather_tiles, gather_tiles_plain
from .ops.scatter import tr_spmv_scatter
from .ops.spmm import tr_spmm, tr_spmm_plain
from .ops.trspmv import tr_spmv, tr_spmv_plain
from .ops.trspmv2d import tr_spmv_2d, tr_spmv_2d_plain
from .parallel import comm, spmv, stream
from .plan.alternating import AlternatingPacker
from .plan.chunkers import EquiChunker
from .probes._common import warm_up
from .tools.matrices import blocky_matrix
from .utils.timing import paired_ms

__all__ = ["entry", "dryrun_multichip", "rank_paths", "dryrun_jobs",
           "kernel_calls", "against_plain", "PATHS", "PLAIN", "KERNELS", "TOL"]

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "data", "corpus.npz")
FLAGSHIP = "HB__can_292"
# |y - y_f64| / max|y_f64| for every path (f32 sums in another order)
TOL = 2e-5
# the kernel wrappers counted on a distributed path, each with its plain
# version (no path launches the element gather since the halo tiles move
# by tile copy; it stays counted, so that a launch of it would show)
PLAIN = {tr_spmv: tr_spmv_plain, tr_spmv_scatter: tr_spmv_plain,
         tr_spmm: tr_spmm_plain, tr_spmv_2d: tr_spmv_2d_plain, gather: gather_plain,
         gather_tiles: gather_tiles_plain}
KERNELS = tuple(PLAIN)


def _flagship():
    """``HB__can_292`` from ``data/corpus.npz`` as f32, and its 1-D pack
    (W = 8, the min-memory plan)."""
    z = np.load(CORPUS)
    A = sp.csc_matrix(
        (z[f"{FLAGSHIP}__data"], z[f"{FLAGSHIP}__indices"],
         z[f"{FLAGSHIP}__indptr"]),
        shape=tuple(z[f"{FLAGSHIP}__shape"])).astype(np.float32)
    return A, vbc1d(A, 8)


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is ``A.T @ x`` on the flagship pack
    through the kernel the operator routes it to, x from seed 0."""
    A, B = _flagship()
    _, fmt, call = route_tr_spmv(B, device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.shape[0]).astype(np.float32)).to(device)
    return call, (fmt, x)


# path -> (shard it, its keyword arguments, run it, which x it takes: the
# whole or the rank's tiles); "stripes" is the column-stripe path
PATHS = {
    "tr_spmv": (spmv.shard_vbc, {}, spmv.dist_tr_spmv, "whole"),
    "spmv": (spmv.shard_vbc, {}, spmv.dist_spmv, "whole"),
    "tr_spmm": (spmv.shard_vbc, {}, spmv.dist_tr_spmm, "whole"),
    "spmm": (spmv.shard_vbc, {}, spmv.dist_spmm, "whole"),
    "replicated": (stream.shard_stream, {}, stream.dist_tr_spmv_replicated, "own"),
    "halo": (stream.shard_stream, {}, stream.dist_tr_spmv_halo, "own"),
    "overlap": (stream.shard_stream, {}, stream.dist_tr_spmv_halo_overlap, "own"),
    "stripes": (stream.shard_stream, {"balance": "even"},
                stream.dist_tr_spmv_replicated, "own"),
    "2d": (stream.shard_stream, {}, stream.dist_tr_spmv_replicated, "own"),
    "2d_halo": (stream.shard_stream, {}, stream.dist_tr_spmv_halo, "own"),
}


def _shard_stats(path, sh) -> dict:
    stats = {"columns": int(sh.host.n), "stored": int(np.asarray(sh.host.val).size)}
    if path in ("halo", "overlap", "2d_halo"):
        stats.update(tiles_per_dev=sh.halo.tiles_per_dev, hmax=sh.halo.hmax,
                     received=sh.halo.received(sh.rank))
    if path == "overlap":
        order, k = sh.overlap
        stats.update(stripes=int(order.size), local=k)
    return stats


def kernel_calls(path, sh, arg, options) -> list:
    """The path's kernel launches on this rank, each on the inputs the path
    gives it: ``[(kernel, args)]``, ``kernel(*args)`` the launch and
    ``PLAIN[kernel](*args)`` its plain version (the path's collectives run
    once, here, on every rank alike).  Empty for a path with no kernel."""
    if path in ("spmv", "spmm") or (path in ("tr_spmv", "tr_spmm")
                                    and not sh.kernels_take(arg)):
        return []  # the semiring route: no kernel
    if path == "tr_spmv":
        _, fmt, call = sh.route
        return [(call, (fmt, arg))]
    if path == "tr_spmm":
        return [(tr_spmm, (sh.spmm_fmt, arg))]
    if path in ("replicated", "stripes", "2d"):
        x = comm.all_gather_x(arg, sh.m, sh.group)
        return [(sh.kernel, (sh.fmt, x, options.get("alpha")))]
    stage, _ = stream._exchange(sh, arg)
    calls = [(gather_tiles, (arg, sh.send_tiles))]
    if path != "overlap":
        if sh.is_2d:
            calls.append((gather_tiles, (stage, sh.pool_tiles)))
        return calls + [(sh.kernel, (sh.halo_fmt, stream._halo_x(sh, stage)))]
    # both launches write one buffer, each its columns (tr_spmv's out)
    local, rest = sh.overlap_fmts
    y = arg.new_zeros(sh.host.n)
    return calls + [(tr_spmv, (local, arg, None, None, None, y)),
                    (tr_spmv, (rest, stage, None, None, None, y))]


def _own(args) -> tuple:
    """``args`` with each tensor copied, so that a call writing into one
    (``tr_spmv``'s ``out``) writes a buffer of its own."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def against_plain(calls) -> dict:
    """``{kernel name: (max |Δ|, max |Δ| / max |plain|)}`` of each kernel
    against its plain version on the same inputs (copies of them), the
    worst of its calls."""
    out = {}
    for kernel, args in calls:
        got, want = kernel(*_own(args)), PLAIN[kernel](*_own(args))
        diff = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        old = out.get(kernel.__name__, (0.0, 0.0))
        out[kernel.__name__] = (max(old[0], diff),
                                max(old[1], diff / scale if scale else diff))
    return out


def _one_at_a_time(rank, world, fn):
    """``fn()`` on each rank in turn, the others waiting (so that ranks
    sharing a card do not time each other's kernels)."""
    out = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            out = fn()
    dist.barrier()
    return out


def _device_ms(fns, device) -> list[float]:
    """``paired_ms`` of ``fns`` on a card kept busy for 0.2 s just before,
    so that the host work between paths leaves no idle card's clocks."""
    warm_up(device, 0.2)
    return paired_ms(fns, device)


def operand(job, device) -> torch.Tensor:
    """A job's x (or X) on ``device``: ``job["x"]`` (NumPy), or f32 normals
    of ``job["shape"]`` from ``job["seed"]`` drawn on the device (the same
    on every rank of one device type and torch build)."""
    if "x" in job:
        return torch.from_numpy(np.ascontiguousarray(job["x"])).to(device)
    gen = torch.Generator(device=device).manual_seed(job["seed"])
    return torch.randn(job["shape"], generator=gen, device=device)


def rank_paths(rank, world, device, jobs, reps=0):
    """Run each job on this rank: ``job = {"path", "B", "x"}`` (a key of
    :data:`PATHS`, a host pack, the whole x or X: :func:`operand`), with
    the path's keyword arguments as ``"options"``, its own ``"reps"`` in
    place of ``reps`` and ``"kernel_ms": False`` to time the walls alone.
    Each job's first call runs between a reset and a read of the kernels'
    launch counts.  Returns a record a job: ``y``
    (rank 0 only), ``launches``, the shard's ``stats``, ``plain``
    (:func:`against_plain` of the path's :func:`kernel_calls`; on the CPU
    a wrapper runs its plain version, so there it checks only which
    kernels the path calls) and, with reps on a CUDA device, ``wall_ms`` (median host wall of the
    reps, each started together on every rank and ended by a synchronize)
    and ``kernel_ms``
    (``{kernel name: device ms of its launches in one call of the path}``,
    CUDA events, ranks one at a time)."""
    out = []
    for job in jobs:
        path = job["path"]
        shard_fn, shard_options, call, takes = PATHS[path]
        options = job.get("options", {})
        sh = shard_fn(job["B"], device=device, **shard_options)
        x = operand(job, device)
        arg = stream.own_x(sh, x) if takes == "own" else x
        for k in KERNELS:
            k.launches = 0
        y = call(sh, arg, **options)
        rec = {"path": path, "name": job.get("name", path),
               "launches": {k.__name__: k.launches for k in KERNELS if k.launches},
               "stats": _shard_stats(path, sh),
               "y": y.cpu().numpy() if rank == 0 else None}
        calls = kernel_calls(path, sh, arg, options)
        rec["plain"] = against_plain(calls)
        n_reps = job.get("reps", reps)
        if n_reps and device.type == "cuda":
            walls = []
            for _ in range(n_reps):
                dist.barrier()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                call(sh, arg, **options)
                torch.cuda.synchronize(device)
                walls.append((time.perf_counter() - t0) * 1e3)
            rec["wall_ms"] = statistics.median(walls)
            if not job.get("kernel_ms", True):
                out.append(rec)
                continue
            by_kernel = {}
            for k, args in calls:
                by_kernel.setdefault(k.__name__, []).append((k, args))
            fns = [lambda g=g: [k(*args) for k, args in g]
                   for g in by_kernel.values()]
            rec["kernel_ms"] = dict(zip(by_kernel, _one_at_a_time(
                rank, world, lambda: _device_ms(fns, device)))) if fns else None
        out.append(rec)
    return out


def _blocky2d(K=3000, u=3, w=4, d=4, band=40, seed=7):
    """A banded matrix of dense u x w tiles (the JAX dry-run's 2-D matrix,
    at K = 3,000 block rows): 1,024 is not a multiple of u, so some tiles
    straddle two x tiles."""
    rng = np.random.default_rng(seed)
    rb = np.clip(np.arange(K)[:, None] + rng.integers(-band, band, (K, d)), 0, K - 1)
    rows = np.repeat(rb.reshape(-1)[:, None] * u + np.arange(u)[None, :], w,
                     axis=0).reshape(-1)
    cols = (np.repeat(np.repeat(np.arange(K) * w, d), u)[:, None]
            + np.arange(w)[None, :]).reshape(-1)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(K * u, K * w)).tocsc()
    A.sum_duplicates()
    return A


def _two_widths(S, seed=9):
    """A banded matrix whose plan alternates stripes of width 8 and 4 (the
    JAX dry-run's multi-class column-stripe case), with that plan."""
    rng = np.random.default_rng(seed)
    widths = np.where(np.arange(S) % 2 == 0, 8, 4)
    spl = np.concatenate([[0], np.cumsum(widths)])
    m = int(spl[-1])
    rr = np.clip(spl[:-1, None] + rng.integers(-200, 200, (S, 5)), 0, m - 1)
    rows = np.repeat(rr, widths, axis=0).reshape(-1)
    cols = np.repeat(np.arange(m), 5)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, m)).tocsc()
    A.sum_duplicates()
    return A, SplitPartition(spl)


def dryrun_jobs(n_devices: int):
    """The dry-run's jobs and, for each, the f64 product it must match:
    ``[(job, want), ...]``."""
    A, B = _flagship()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    X = rng.standard_normal((A.shape[0], 8)).astype(np.float32)
    A64 = A.astype(np.float64)
    out = [({"path": "tr_spmv", "B": B, "x": x}, A64.T @ x),
           ({"path": "tr_spmm", "B": B, "x": X}, A64.T @ X)]
    A1 = blocky_matrix(L=4096, band=400)
    B1 = vbc1d(A1, 8)
    x1 = np.random.default_rng(3).standard_normal(A1.shape[0]).astype(np.float32)
    out += [({"path": p, "B": B1, "x": x1}, A1.T.astype(np.float64) @ x1)
            for p in ("replicated", "halo", "overlap")]
    A2 = _blocky2d()
    B2 = vbc2d(A2, 3, 4, AlternatingPacker(EquiChunker(4), EquiChunker(3)))
    x2 = np.random.default_rng(7).standard_normal(A2.shape[0]).astype(np.float32)
    out += [({"path": p, "B": B2, "x": x2}, A2.T.astype(np.float64) @ x2)
            for p in ("2d", "2d_halo")]
    A3, spl3 = _two_widths(512 * n_devices)
    B3 = vbc1d(A3, 8, spl3)
    x3 = np.random.default_rng(9).standard_normal(A3.shape[0]).astype(np.float32)
    out.append(({"path": "stripes", "B": B3, "x": x3},
                A3.T.astype(np.float64) @ x3))
    return out


def rel_err(got, want) -> float:
    """``max|got - want| / max|want|`` (the absolute error when want is 0)."""
    scale = float(np.abs(want).max(initial=0.0)) or 1.0
    return float(np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)) / scale


def dryrun_multichip(n_devices: int, device="cuda", *, backend: str) -> dict:
    """Start ``n_devices`` ranks on ``device`` over ``backend`` and run one
    step of every distributed path, each against the f64 host product
    and, on the card, each kernel against its plain version on the same
    inputs (raises ``AssertionError`` beyond :data:`TOL`).  Prints a line a path
    group, the overlap's local-stripe count on each rank among them, and
    returns ``{path: {"err", "y" (rank 0's), "launches", "stats" (a list,
    a rank)}}``."""
    jobs = dryrun_jobs(n_devices)
    names = [job["path"] for job, _ in jobs]
    ranks = comm.run_ranks(rank_paths, n_devices, backend, device,
                           [job for job, _ in jobs])
    summary = {}
    for i, (name, (_, want)) in enumerate(zip(names, jobs)):
        err = rel_err(ranks[0][i]["y"], want)
        assert err <= TOL, f"dryrun {name}: |dy|/max|y| {err:.3e} > {TOL}"
        for d, r in enumerate(ranks):
            for kernel, (_, e) in r[i]["plain"].items():
                assert e <= TOL, (f"dryrun {name}: rank {d}'s {kernel} is "
                                  f"{e:.3e} off its plain version")
        summary[name] = {"err": err, "y": ranks[0][i]["y"],
                         "launches": ranks[0][i]["launches"],
                         "stats": [r[i]["stats"] for r in ranks]}
    where = f"{n_devices} ranks ({backend}, {device})"
    print(f"dryrun_multichip OK: {where}, TrSpMV n={jobs[0][0]['B'].n} + TrSpMM "
          f"k=8 match the host oracle", flush=True)
    local = [s["local"] for s in summary["overlap"]["stats"]]
    assert min(local) > 0, f"dryrun: a rank has no local stripe: {local}"
    recv = [s.get("received") for s in summary["halo"]["stats"]]
    print(f"dryrun_multichip OK: stripe-sharded stripe kernel (replicated x, "
          f"tile halo received {recv} of {summary['halo']['stats'][0]['tiles_per_dev']} "
          f"tiles a rank, and OVERLAPPED halo, local stripes a rank {local}) "
          f"on {where} matches the host oracle", flush=True)
    print(f"dryrun_multichip OK: stripe-sharded 2-D tile kernel (replicated x "
          f"and tile halo) on {where} matches the host oracle", flush=True)
    print(f"dryrun_multichip OK: column-stripe-sharded stripe kernel (widths "
          f"8 and 4) on {where} matches the host oracle", flush=True)
    return summary


if __name__ == "__main__":
    dryrun_multichip(4, backend="gloo")
