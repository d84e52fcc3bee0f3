"""The benchmark's command: one run of one cell on one card.

    python3 -m spbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up's phases, the card and the sample count on earlier
lines, the numbers compared with their limits as the last lines of
standard error, and the result as the last line of standard output.
Exits with 1, and prints no result, without a CUDA card (or fewer than
the cell asks for), and with 3 if JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the JAX side's top-level modules, none of which a run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "vbcs_tpu", "bench", "bench_tools")


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _card_limits() -> str:
    """``nvidia-smi``'s name and power limit of the cards (read once the
    window has closed, so that its start-up is not in the set-up)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"no reading ({type(e).__name__})"
    return proc.stdout.strip().replace("\n", "; ")


def _build_s() -> float:
    """Build the port's kernel library and its host planner's library
    into the checkout's ``build/`` where they are missing or stale (a
    checkout's first run); the seconds it took, 0 where nothing was
    built.  They are part of the set-up, printed as a phase of their own."""
    t0 = time.perf_counter()
    from vbcs_tpu_torch import native
    from vbcs_tpu_torch.ops import _lib

    built = _lib.build()[0] + native.build()
    return time.perf_counter() - t0 if built else 0.0


def _forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    started = min(STARTED, time.perf_counter() - _process_age_s())
    ap = argparse.ArgumentParser(prog="spbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import harness

    cell = harness.cell_of(harness.load_manifest(), args.workload, bool(args.trace))
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name = torch.cuda.get_device_name(0) if have else "none"
    if have < cell.chips:
        print(f"spbench: the cell needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 1
    result, run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   "cuda:0", started, phases={"build_s": _build_s()})
    print(f"card {name!r}, {have} device(s), nvidia-smi: {_card_limits()}", flush=True)
    result["metrics"] = harness.read_metrics(cell, run)
    result["device"] = {"platform": "gpu", "kind": name, "count": cell.chips,
                        **result["device"]}
    if run.window.latencies_us:
        print(f"latency samples {len(run.window.latencies_us)}", flush=True)
    loaded = _forbidden_loaded()
    if loaded:
        print(f"spbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
