"""A cell's run with the port's own tracer on: its spans and its launch
counter, split into set-up and window, and the per-layer readings they
give.

    python3 -m spbench.spans --workload <cell> --seed <n> --seconds <s> [--trace 0|1]

The run is ``spbench.run``'s (``harness.run_cell``), with the tracer
(``vbcs_tpu_torch.utils.trace``) enabled just before ``from_csc`` and
kept on through the warm-up and the window.  Prints one ``spans {json}``
line (count, total and self seconds per span name, for the set-up and
for the window; the window's and all traced calls; the launches they
made; the readings) before the result line, which it prints as
``spbench.run`` does.  The window's calls run with the tracer on, so
its ``dispatch_us`` holds the tracer's cost; ``spbench.run`` itself never
turns the tracer on.  Exits with 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from vbcs_tpu_torch.utils import trace

from . import harness
from . import run as command

# the root span of each operator call (vbcs_tpu_torch/operator.py)
CALL_ROOTS = ("op.tr_mul", "op.mul", "op.tr_mul_mat", "op.mul_mat", "op.tr_mul_chain")
# planner readings: the set-up spans each sums
PLANNER = {"reorder_s": ("plan.badness", "plan.rcm"), "dp_s": ("plan.dp",),
           "pack_s": ("plan.pack", "plan.transpose"), "upload_s": ("plan.upload",)}


class Tracing:
    """``operator`` is a ``make_operator`` for ``harness.run_cell`` that
    turns the tracer on before ``from_csc``; ``finish(run)`` turns it off
    and returns what it recorded."""

    def __init__(self):
        self.launches0 = 0

    def operator(self, A, cfg, t, device):
        trace.reset()
        self.launches0 = trace.launches()
        trace.enable()
        return harness.program_operator(A, cfg, t, device)

    def finish(self, run: harness.Run) -> dict:
        trace.disable()
        spans = trace.snapshot()["spans"]
        launches = trace.launches() - self.launches0
        trace.reset()
        out = split(spans, run.window.calls)
        out["launches"] = launches
        out["readings"] = readings(out)
        return out


def split(spans: list, window_calls: int) -> dict:
    """The window's spans are those of its calls, the last
    ``window_calls`` operator calls recorded; every other span is the
    set-up's (``from_csc``, a route built outside a call, the warm-up)."""
    calls = [s["call"] for s in spans if s["parent"] == -1 and s["name"] in CALL_ROOTS]
    window = set(calls[len(calls) - window_calls:]) if window_calls else set()
    return {"setup": trace.summary(spans, lambda s: s["call"] not in window),
            "window": trace.summary(spans, lambda s: s["call"] in window),
            "window_calls": len(window), "calls": len(calls)}


def readings(spans: dict) -> dict:
    """Seconds of the planner's parts in set-up; the host's microseconds
    a window call spends in the operator outside its launch and in its
    launch; launches a traced call.  None where no such span was
    recorded."""
    setup, window, n = spans["setup"], spans["window"], spans["window_calls"]
    out = {}
    for metric, names in PLANNER.items():
        found = [setup[k]["total_s"] for k in names if k in setup]
        out[metric] = sum(found) if found else None
    launch = window.get("op.launch")
    roots = sum(window[k]["total_s"] for k in CALL_ROOTS if k in window)
    out["operator_host_us"] = (roots - launch["total_s"]) / n * 1e6 if launch and n else None
    out["launch_host_us"] = launch["total_s"] / n * 1e6 if launch and n else None
    calls = spans["calls"]
    out["launches_per_call"] = spans["launches"] / calls if calls else None
    return out


def main(argv=None) -> int:
    started = min(command.STARTED, time.perf_counter() - command._process_age_s())
    ap = argparse.ArgumentParser(prog="spbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.cell_of(harness.load_manifest(), args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        print("spbench.spans: needs a CUDA card", file=sys.stderr)
        return 1
    tracing = Tracing()
    result, run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   "cuda:0", started, make_operator=tracing.operator,
                                   phases={"build_s": command._build_s()})
    print("spans " + json.dumps(tracing.finish(run)), flush=True)
    result["metrics"] = harness.read_metrics(cell, run)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
