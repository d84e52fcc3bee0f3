"""Probe: the host-side stages of planning and packing, each timed.

Port of ``bench_tools/probe_pack.py``, on the port's own stages, for the
JAX bench's flagship (``tools.matrices.blocky_matrix()``: 320,000
columns, 2.55M nonzeros) and its scrambled FEM (``fem_matrix()``):

* ``gen``: the matrix from its generator;
* ``plan host DP``: the min-memory plan, ``DynamicTotalChunker(
  model_1dvbc_memory(4, 8), 8)`` (the C++ DP), as the JAX probe's plan;
* ``plan device DP``: the same plan by ``dp_partition_device`` (the DP's
  kernels, ``ops/dp.py``), held equal to the host's; copies to the device
  and the backtrack included;
* ``vbc1d pack``: ``pack_1dvbc`` of that plan;
* ``VBC1DDevice`` and ``ScatterDevice``: the pack copied to the device in
  the stripe kernel's and the scatter kernel's formats;
* on the FEM, ``from_csc (auto-RCM)``: ``VBCOperator.from_csc(A, W=8)``,
  the whole set-up of an operator, relabeling included.

The JAX probe's ``pack_stream2``/``pack_stream3`` stages build the Mosaic
stream layouts, which the port does not have: the device formats above
take their place.  ``--profile`` runs cProfile over the pack stages (the
1D-VBC pack and both device formats) and prints the 25 costliest calls.
A device stage ends in a synchronize.  Times are the host's clock.

Run on the card:  python -m vbcs_tpu_torch.probes.probe_pack [flagship|fem|all] [--profile]
(``--device cpu`` runs the plain versions.)
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time

import numpy as np
import torch

from ..api import vbc1d
from ..formats.csc import CSC
from ..formats.device import ScatterDevice, VBC1DDevice
from ..models.cost import model_1dvbc_memory
from ..operator import VBCOperator
from ..plan.alternating import pack_stripe
from ..plan.device_dp import dp_partition_device
from ..plan.dynamic import DynamicTotalChunker
from ..tools.matrices import blocky_matrix, fem_matrix

__all__ = ["W", "stage", "pack_stages", "run", "main"]

W = 8  # the JAX probe's width cap (probe_pack.py:40-41)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stage(times: dict, name: str, fn, device=None):
    """Run ``fn()``, record its seconds under ``name`` (after a synchronize
    of ``device`` when given) and print the JAX probe's line."""
    t0 = time.perf_counter()
    out = fn()
    if device is not None:
        _sync(device)
    times[name] = time.perf_counter() - t0
    print(f"{name:28s} {times[name]:8.2f} s", flush=True)
    return out


def _device_packs(B, device):
    return VBC1DDevice.from_host(B, device), ScatterDevice.from_host(B, device)


def pack_stages(A, device, times: dict, profile: bool = False):
    """The plan, pack and device stages of one matrix (f32 CSC) into
    ``times``; returns the pack.  Raises ``RuntimeError`` when the device
    DP's plan differs from the host DP's."""
    C = CSC.from_scipy(A)
    model = model_1dvbc_memory(4, W)
    Phi = stage(times, "plan host DP",
                lambda: pack_stripe(C, DynamicTotalChunker(model, W)))
    Phi_dev = stage(times, "plan device DP",
                    lambda: dp_partition_device(C, model, W, device=device), device)
    if not np.array_equal(Phi.spl, Phi_dev.spl):
        raise RuntimeError("dp_partition_device's plan differs from the host DP's")
    if profile:
        prof = cProfile.Profile()
        prof.enable()
        B = vbc1d(C, W, Phi)
        _device_packs(B, device)
        _sync(device)
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(25)
        print(out.getvalue(), flush=True)
        return B
    B = stage(times, "vbc1d pack", lambda: vbc1d(C, W, Phi))
    stage(times, "VBC1DDevice", lambda: VBC1DDevice.from_host(B, device), device)
    stage(times, "ScatterDevice", lambda: ScatterDevice.from_host(B, device), device)
    return B


def run(which: str = "all", device="cuda", profile: bool = False) -> dict:
    """``{matrix: {stage: seconds}}`` for ``which`` in flagship, fem, all."""
    if which not in ("flagship", "fem", "all"):
        raise ValueError(f"which must be flagship, fem or all, got {which!r}")
    device = torch.device(device)
    out = {}
    if which in ("all", "flagship"):
        print("=== flagship blocky ===", flush=True)
        times = out["flagship"] = {}
        A = stage(times, "gen", blocky_matrix)
        pack_stages(A, device, times, profile)
    if which in ("all", "fem"):
        print("=== FEM scrambled Laplacian ===", flush=True)
        times = out["fem"] = {}
        Af = stage(times, "gen", lambda: fem_matrix().astype(np.float32))
        stage(times, "from_csc (auto-RCM)",
              lambda: VBCOperator.from_csc(Af, W=W, device=device), device)
        pack_stages(Af, device, times, profile)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("flagship", "fem", "all"))
    ap.add_argument("--profile", action="store_true",
                    help="cProfile over the pack stages")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; --device cpu runs "
                           "the plain versions")
    out = run(args.which, args.device, args.profile)
    print("PACK " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
