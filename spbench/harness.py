"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics.  ``run.py`` is the command; this module
takes the device as an argument so that the tests can drive a whole run
on the CPU at a small size (where the port runs its plain versions)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import time

import numpy as np
import torch

from .reference import Matrix

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")
# seconds of the window a --trace 1 run captures, from its middle
TRACE_SECONDS = 2.0
# warm-up: at least two sync groups and this many seconds
WARM_SECONDS = 0.25


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``spbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(ROOT, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"spbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the manifest's metric entries this run reports


def cell_of(manifest: dict, name: str, trace: bool) -> Cell:
    """The workload ``name`` with its configuration, traffic, limits and
    the metrics a run of it reports (end-to-end, or with ``trace`` the
    per-layer ones, each where its ``workloads`` name the cell or it has
    none)."""
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    metrics = [m for m in manifest["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]),
                limits=load_json("limits", name), metrics=metrics)


def _seed_of(seed: int) -> int:
    return seed % (2**63)


def program_operator(A, config, traffic, device):
    """The system under test: the port's operator, planned and packed
    for the one direction the traffic calls."""
    from vbcs_tpu_torch.operator import VBCOperator

    return VBCOperator.from_csc(A, W=config["W"], directions=traffic["direction"],
                                reorder=config["reorder"], device=device)


def stored_bytes(op) -> int | None:
    memory = getattr(op, "memory_bytes", None)
    return None if memory is None else int(memory())


def describe(op, t) -> str:
    """The packed direction's route and relabeling, as far as ``op``
    tells (the control operator tells nothing)."""
    which = "tr" if t["direction"] == "transposed" else "fw"
    host = getattr(op, f"host_{which}", None)
    if host is None:
        return type(op).__name__
    widths = np.diff(np.asarray(host.Phi.spl, dtype=np.int64))
    route = getattr(op, f"route_{which}")[0] if t["call"] in ("tr_mul", "mul") else t["call"]
    return (f"{t['direction']} pack, {widths.size} stripes of mean width "
            f"{widths.mean():.3f}, auto-RCM {'on' if op.row_perm is not None else 'off'}, "
            f"route {route}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    calls: int
    elapsed_s: float
    samples: list  # (call index, operand index, y in, output)
    latencies_us: list
    dispatch_s: float
    dispatch_calls: int
    capture: object | None


def drive(op, call, t, xs, y0, seconds, device, sample_at=(), trace=False) -> Window:
    """The closed loop of one caller: ``t["sync_every"]`` calls, then a
    synchronize, until ``seconds`` have passed at a sync point.  Calls
    cycle through the operands ``xs``; with ``t["chain_y"]`` each call's
    output is the next one's y.  Keeps (by reference) the calls in
    ``sample_at`` and the last one; with ``t["latency"]`` times each
    request on the host clock, from the call's entry to the return of
    the synchronize that ends it; with ``trace`` profiles
    ``TRACE_SECONDS`` from the window's middle, between sync points."""
    group = int(t["sync_every"])
    timed = bool(t.get("latency"))
    if timed and group != 1:
        raise ValueError("a latency mix synchronizes after every call")
    sample_at = set(sample_at)
    latencies, samples = [], []
    calls, y, last = 0, y0, None
    disp, disp_n = 0.0, 0
    capture, capturing, captured, cap_from = None, False, False, None
    start = time.perf_counter()
    deadline = start + seconds
    if trace:
        from .trace import Capture

        capture = Capture()
        cap_from = start + max(0.0, seconds - TRACE_SECONDS) / 2
    while True:
        for _ in range(group):
            k = calls % len(xs)
            c0 = time.perf_counter()
            out = call.invoke(op, t, xs[k], y)
            c1 = time.perf_counter()
            if not capturing:
                disp += c1 - c0
                disp_n += 1
            rec = (calls, k, y, out)
            if calls in sample_at:
                samples.append(rec)
            last = rec
            if t.get("chain_y"):
                y = out
            calls += 1
        _sync(device)
        now = time.perf_counter()
        if timed:
            latencies.append((now - c0) * 1e6)
        if capture is not None:
            if not captured and now >= cap_from:
                capture.start()
                capturing, captured, cap_calls = True, True, calls
                cap_t = time.perf_counter()
            elif capturing and (now >= cap_t + TRACE_SECONDS or now >= deadline):
                capture.stop(calls - cap_calls)
                capturing = False
        if now >= deadline and not capturing:
            break
    elapsed = now - start
    if last is not None and (not samples or samples[-1][0] != last[0]):
        samples.append(last)
    return Window(calls, elapsed, samples, latencies, disp, disp_n, capture)


def warm(op, call, t, xs, y0, device, hold: int = 0) -> float:
    """Run the cell's own call in sync groups for at least two groups,
    ``WARM_SECONDS`` and ``hold`` calls, holding the outputs of the last
    ``hold`` calls until the end: the allocator then keeps blocks for the
    outputs the window keeps as samples, and allocates none from the
    device inside the window.  Returns the seconds a call took after the
    first group."""
    group = int(t["sync_every"])
    y, calls, rounds, held = y0, 0, 0, []
    t0 = time.perf_counter()
    t1 = None
    while rounds < 2 or calls < hold or time.perf_counter() - t0 < WARM_SECONDS:
        for _ in range(group):
            out = call.invoke(op, t, xs[calls % len(xs)], y)
            held = (held + [out])[-hold:] if hold else held
            if t.get("chain_y"):
                y = out
            calls += 1
        _sync(device)
        rounds += 1
        if rounds == 1:
            t1, calls1 = time.perf_counter(), calls
    return (time.perf_counter() - t1) / max(1, calls - calls1)


def sample_points(seed: int, n: int, expected_calls: int) -> list:
    """Call 0 and ``n`` calls drawn from the seed below the calls the
    window is expected to make (the last call is always kept too)."""
    rng = np.random.default_rng([_seed_of(seed), 17])
    hi = max(2, int(expected_calls))
    return sorted({0, *rng.integers(1, hi, size=n).tolist()})


def judge(A, call, t, xs, samples, device) -> list:
    """Each sampled output's largest gap to the float64 reference, over
    the reference's largest magnitude."""
    ref = Matrix(A, device)
    errs = []
    for _, k, y_in, out in samples:
        want = call.expect(ref, t, xs[k], y_in)
        scale = want.abs().max().item()
        gap = (out.to(torch.float64) - want).abs().max().item()
        errs.append(gap / scale if scale > 0 else gap)
    return errs


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    card: str
    nnz: int
    m: int
    n: int
    work: dict  # one call's count (work/<call>.py)
    setup_s: float
    phases: dict
    stored_bytes: int | None
    window: Window
    trace: dict | None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started_s: float, make_operator=program_operator,
             log=print, phases=None) -> tuple[dict, Run]:
    """A whole run; ``started_s`` is ``time.perf_counter()`` at process
    start, ``phases`` the set-up phases timed before the call.  Returns
    the result line (without ``device``'s card name and count, which the
    caller adds) and what the metrics were read from."""
    device = torch.device(device)
    cfg, t = cell.config, cell.traffic
    gen_mod = load_module("gen", cfg["generator"])
    call = load_module("calls", t["call"])
    work_mod = load_module("work", t["call"])
    phases = {**(phases or {}), "start_s": time.perf_counter() - started_s}

    t0 = time.perf_counter()
    A = gen_mod.generate(_seed_of(seed), **cfg["args"])
    m, n = A.shape
    phases["generate_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    op = make_operator(A, cfg, t, device)
    _sync(device)
    phases["from_csc_s"] = time.perf_counter() - t0
    log(f"matrix {m}x{n}, {A.nnz} nonzeros; operator: {describe(op, t)}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed))
    dtype = torch.from_numpy(np.zeros(0, A.dtype)).dtype
    xs = call.operands(t, m, n, gen, device, dtype)
    y0 = call.first_y(t, m, n, gen, device, dtype)
    _sync(device)
    phases["operands_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # the window keeps two outputs a sample (its y and its result) and the last call's
    per_call = warm(op, call, t, xs, y0, device, hold=2 * int(t["samples"]) + 4)
    if trace:  # the profiler's first start takes seconds: not in the window
        from .trace import Capture

        first = Capture()
        first.start()
        first.stop(0)
    phases["warm_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started_s
    phases["setup_s"] = setup_s
    log("setup phases " + json.dumps(phases))

    at = sample_points(seed, int(t["samples"]), 0.9 * seconds / max(per_call, 1e-9))
    win = drive(op, call, t, xs, y0, seconds, device, at, trace)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    nbytes = stored_bytes(op)
    del op
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = win.capture.summary() if win.capture is not None else None
    errs = judge(A, call, t, xs, win.samples, device)
    limit = cell.limits["rel_err"]
    bad = [e for e in errs if not e <= limit]  # NaN is bad too
    # the largest reading, or None (JSON null) where there is none or a NaN
    value = max(errs) if errs and all(math.isfinite(e) for e in errs) else None
    correct = bool(errs) and not bad
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cell=cell, card=card, nnz=int(A.nnz), m=m, n=n,
              work=work_mod.count(int(A.nnz), m, n, t), setup_s=setup_s,
              phases=phases, stored_bytes=nbytes, window=win, trace=summary)
    result = {
        "correct": correct,
        "attempted": win.calls,
        "failed": len(bad) if errs else win.calls,
        "metrics": {},
        "device": {"memory_peak_bytes": int(peak)},
        "checks": {"rel_err": {"value": value, "limit": limit}},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    log(f"samples judged {len(errs)}: " + " ".join(f"{e:.3e}" for e in errs))
    return result, run


def read_metrics(cell: Cell, run: Run) -> dict:
    """Each metric's reader (``metrics/<name>.py``); one that finds
    nothing to read is left out."""
    out = {}
    for m in cell.metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
