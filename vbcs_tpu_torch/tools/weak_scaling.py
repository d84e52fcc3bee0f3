"""Weak scaling of the stripe-sharded TrSpMV, measured and modelled.

Port of ``bench_tools/weak_scaling.py`` on ``vbcs_tpu_torch.parallel``.
For each world size N in 1, 2, 4, ... up to ``--world``: the banded
blocky matrix ``blocky_matrix(L=l0 * N, w, d, band)`` (constant work a
rank) packed under ``EquiChunker(w)``, and one TrSpMV through the
replicated, tile-halo and overlapped-halo paths of ``parallel/stream.py``
in a world of N ranks (``comm.run_ranks``; ``entry.rank_paths`` runs the
paths, checks their kernels against the plain versions and times them).
A row: the host wall of a call (the median over ``--reps``, every rank
started together and ended by a synchronize) and its Gnnz/s; the device
time of a call's kernels (CUDA events, ranks one at a time; the slowest
rank) and its Gnnz/s; the halo a rank receives, ``(N - 1) * hmax`` tiles
of 4 KiB; and the efficiency of the wall against N = 1 of the same path.
Every ``y`` is held against the f64 product.

The analytic model takes its single-card rate from the kernel time of the
measured N = 1 row of the replicated path (or ``--rate``; it raises with
neither), a device rate as the JAX harness's ``periter`` rate is (the
host's constants cancel there); the same row's wall rate stands beside it.
The link rate ``--link-gbs`` is an assumption printed as such: a rank's
compute is ``nnz / N / rate``, its halo ``halo bytes / link``; the
sequential halo path's efficiency is ``compute / (compute + halo)``, the
overlapped one's ``compute / max(compute, halo)``.

On one card, the ranks of N > 1 share it over gloo (NCCL refuses two ranks
of one world on one card): those rows measure the plan, the collectives'
host copies and the host, not scaling.  On the CPU (``--device cpu``)
nothing is timed, and the model needs ``--rate``.

Run on the card:  python -m vbcs_tpu_torch.tools.weak_scaling [--l0 10000] [--world 4]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..api import vbc1d
from ..entry import TOL, rank_paths, rel_err
from ..parallel import comm
from ..parallel.shard import TILE
from ..plan.chunkers import EquiChunker
from .matrices import blocky_matrix

__all__ = ["PATHS", "world_sizes", "measure", "analytic", "main"]

PATHS = ("replicated", "halo", "overlap")
TILE_BYTES = TILE * 4  # one f32 x tile
SHARED_CARD = ("the ranks of N > 1 share one card over gloo: these rows "
               "measure the plan, the collectives' host copies and the host, "
               "not scaling")


def world_sizes(world: int) -> list[int]:
    """1, 2, 4, ... up to ``world``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    sizes = [1]
    while sizes[-1] * 2 <= world:
        sizes.append(sizes[-1] * 2)
    return sizes


def _backend(device, ndev: int) -> str:
    if device.type == "cuda" and ndev <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def measure(l0: int, world: int, device="cuda", *, w: int = 8, d: int = 8,
            band: int = 400, reps: int = 20) -> list[dict]:
    """The measured rows: one a world size and path (``PATHS``)."""
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    rows, base = [], {}
    for ndev in world_sizes(world):
        A = blocky_matrix(L=l0 * ndev, w=w, d=d, band=band)
        B = vbc1d(A, w, EquiChunker(w))
        x = np.random.default_rng(1).standard_normal(A.shape[0]).astype(np.float32)
        want = A.T.astype(np.float64) @ x
        backend = _backend(device, ndev)
        jobs = [{"path": p, "B": B, "x": x, "reps": reps} for p in PATHS]
        ranks = comm.run_ranks(rank_paths, ndev, backend, str(device), jobs)
        hmax = ranks[0][PATHS.index("halo")]["stats"]["hmax"]
        for i, path in enumerate(PATHS):
            err = rel_err(ranks[0][i]["y"], want)
            if err > TOL:
                raise RuntimeError(f"N={ndev} {path}: |dy|/max|y| {err:.3e} > {TOL}")
            wall = ranks[0][i].get("wall_ms")
            t_us = None if wall is None else max(r[i]["wall_ms"] for r in ranks) * 1e3
            rate = None if t_us is None else A.nnz / (t_us * 1e-6)
            k_us = (None if not ranks[0][i].get("kernel_ms") else
                    max(sum(r[i]["kernel_ms"].values()) for r in ranks) * 1e3)
            if ndev == 1:
                base[path] = rate
            eff = (rate / (base[path] * ndev)
                   if rate is not None and base.get(path) else None)
            rows.append(dict(
                ndev=ndev, path=path, backend=backend, nnz=int(A.nnz),
                t_us=t_us, gnnz_s=None if rate is None else rate / 1e9,
                kernel_us=k_us,
                kernel_gnnz_s=None if k_us is None else A.nnz / k_us / 1e3,
                halo_kib=(ndev - 1) * hmax * TILE_BYTES / 1024 if ndev > 1 else 0.0,
                hmax=int(hmax), efficiency=eff, err=err,
                platform="gpu" if device.type == "cuda" else "cpu",
                shared_card=device.type == "cuda" and ndev > cards))
    return rows


def analytic(rows: list[dict], rate: float | None = None,
             link_gbs: float = 450.0) -> dict:
    """The model's rows, one a world size, from the halo path's rows:
    ``rate`` Gnnz/s a card (default: the kernel time of the measured N = 1
    row of the replicated path; raises ``ValueError`` when there is none)
    and ``link_gbs`` GB/s a rank (an assumption).  ``wall_gnnz_s``: that
    row's host-wall rate, beside it (None when untimed)."""
    source = "--rate"
    n1 = [r for r in rows if r["ndev"] == 1 and r["path"] == "replicated"]
    if rate is None:
        timed = [r for r in n1 if r.get("kernel_gnnz_s") is not None]
        if not timed:
            raise ValueError("the analytic model needs the kernel time of the "
                             "measured N = 1 row of the replicated path, or --rate")
        rate, source = timed[0]["kernel_gnnz_s"], "the kernel time of the measured N = 1 row"
    link = link_gbs * 1e9
    out = []
    for r in rows:
        if r["path"] != "halo":
            continue
        t_comp = r["nnz"] / r["ndev"] / (rate * 1e9)
        t_halo = r["halo_kib"] * 1024 / link
        out.append(dict(
            ndev=r["ndev"], compute_us=t_comp * 1e6, halo_us=t_halo * 1e6,
            modeled_eff_sequential=t_comp / (t_comp + t_halo),
            modeled_eff_overlapped=t_comp / max(t_comp, t_halo)))
    return dict(single_card_gnnz_s=rate, rate_from=source,
                wall_gnnz_s=n1[0]["gnnz_s"] if n1 else None,
                link_gb_s_assumed=link_gbs, rows=out)


def _fmt(v, spec):
    return "-" if v is None else format(v, spec)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--l0", type=int, default=10000, help="stripes a rank")
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--d", type=int, default=8, help="blocks a stripe")
    ap.add_argument("--band", type=int, default=400)
    ap.add_argument("--world", type=int, default=4, help="the largest N")
    ap.add_argument("--reps", type=int, default=20, help="timed calls a path")
    ap.add_argument("--rate", type=float, default=None,
                    help="Gnnz/s a card for the model (default: the measured "
                         "N = 1 row)")
    ap.add_argument("--link-gbs", type=float, default=450.0,
                    help="GB/s a rank receives at (an assumption; 450 is "
                         "NVLink 4 each way on an H100)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; --device cpu runs the "
                           "paths untimed")
    rows = measure(args.l0, args.world, device, w=args.w, d=args.d,
                   band=args.band, reps=args.reps)
    print(f"{'N':>3s} {'path':10s} {'backend':7s} {'nnz':>10s} {'t_us':>9s} "
          f"{'gnnz_s':>8s} {'kernel_us':>9s} {'k_gnnz_s':>8s} {'halo_KiB':>9s} "
          f"{'eff':>5s}")
    for r in rows:
        print(f"{r['ndev']:3d} {r['path']:10s} {r['backend']:7s} {r['nnz']:10d} "
              f"{_fmt(r['t_us'], '9.1f')} {_fmt(r['gnnz_s'], '8.3f')} "
              f"{_fmt(r['kernel_us'], '9.2f')} {_fmt(r['kernel_gnnz_s'], '8.3f')} "
              f"{r['halo_kib']:9.0f} {_fmt(r['efficiency'], '5.2f')}")
    if any(r["shared_card"] for r in rows):
        print(f"NOTE: {SHARED_CARD}")
    model = analytic(rows, args.rate, args.link_gbs)
    print(f"\nanalytic model: single-card rate {model['single_card_gnnz_s']:.3f} "
          f"Gnnz/s ({model['rate_from']}), the N = 1 wall's rate "
          f"{_fmt(model['wall_gnnz_s'], '.3f')} Gnnz/s, link {args.link_gbs:.0f} "
          "GB/s (ASSUMED)")
    print(f"{'N':>3s} {'compute_us':>11s} {'halo_us':>8s} {'eff_seq':>8s} "
          f"{'eff_overlap':>11s}")
    for m in model["rows"]:
        print(f"{m['ndev']:3d} {m['compute_us']:11.2f} {m['halo_us']:8.2f} "
              f"{m['modeled_eff_sequential']:8.3f} {m['modeled_eff_overlapped']:11.3f}")
    out = {"weak_scaling": rows, "analytic_model": model}
    print("WEAK " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
