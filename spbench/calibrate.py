"""The readings a cell's correctness limit is set from, on the card:

    python3 -m spbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2

For each seed, a whole run (generation, ``from_csc``, warm-up, a short
window at the cell's own load, the check) of the port, then of the
control (``control.py``: the reference in TF32 in the port's place), in
one process; prints each run's ``rel_err`` and the largest of the port's
and the smallest of the control's.  Where seeds generate the same matrix
(the stencil has no random part) the port's operator is planned once and
handed to each of them.  The benchmark's runs never run it."""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import torch

from . import harness
from .control import ControlOperator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    cell = harness.cell_of(harness.load_manifest(), args.workload, False)
    planned = {}

    def port(A, cfg, t, dev):
        key = hashlib.sha256(A.indptr.tobytes() + A.indices.tobytes()
                             + A.data.tobytes()).hexdigest()
        if key not in planned:
            planned.clear()
            planned[key] = harness.program_operator(A, cfg, t, dev)
        return planned[key]

    sides = [("port", port, args.seeds),
             ("control", lambda A, cfg, t, dev: ControlOperator(A, dev),
              args.control_seeds)]
    readings = {}
    for side, make, seeds in sides:
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            result, _ = harness.run_cell(cell, seed, args.seconds, False, "cuda:0",
                                         t0, make, log=lambda *a: None)
            value = result["checks"]["rel_err"]["value"]  # None: NaN or no sample
            value = float("inf") if value is None else value
            readings.setdefault(side, []).append(value)
            print(json.dumps({"side": side, "seed": seed, "rel_err": value,
                              "attempted": result["attempted"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
        planned.clear()
    print(json.dumps({"workload": args.workload,
                      "port_max": max(readings.get("port", [0.0])),
                      "control_min": min(readings.get("control", [float("inf")])),
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
