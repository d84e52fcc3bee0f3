"""Kernel timing on a CUDA device with CUDA events.

Port of ``vbcs_tpu/utils/timing.py``.  The JAX package timed by the
difference of two chain lengths because its remote TPU returned from
``block_until_ready`` early; CUDA events record on the stream itself,
so here a rep is ``ITERS`` back-to-back calls between two events.  A
device-side sleep queued ahead of each rep lets the host enqueue the
whole rep before the device reaches the first event, so a short kernel
is timed on the device, not at the host's launch rate.

What stays is the paired-median discipline: every rep times each
candidate once, in alternating order (a b, b a, ...), and each
candidate's estimate is the median over reps, so load drift hits all
candidates alike and bursts are rejected.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Sequence

import torch

__all__ = ["paired_ms", "flushed_ms", "host_ms"]

ITERS = 50  # back-to-back calls per timed rep
REPS = 7  # paired reps; the estimate is their median
WARMUP = 3  # untimed calls of each function first
FLUSH_ITERS = 20  # flushed single-call samples
FLUSH_BYTES = 256 << 20  # overwritten before each flushed call (> any L2)


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device timing needs a CUDA device, got {device}")
    return device


def _elapsed_ms(work: Callable[[], object], before=None) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if before is not None:
        before()
    start.record()
    work()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def paired_ms(fns: Sequence[Callable[[], object]], device,
              iters: int = ITERS) -> list[float]:
    """Median device milliseconds per call of each of ``fns``.

    Each rep times ``iters`` back-to-back calls of every function between
    two CUDA events on the current stream, after a device sleep twice as
    long as the host takes to enqueue them; the order alternates between
    reps.  Raises ``ValueError`` for a non-CUDA device: a CPU clock is no
    device metric."""
    device = _cuda(device)

    def run(f):
        for _ in range(iters):
            f()

    with torch.cuda.device(device):
        enqueue_ms = 0.0
        for f in fns:
            for _ in range(WARMUP):
                f()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run(f)
            enqueue_ms = max(enqueue_ms, (time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize(device)
        probe = 1 << 20
        ms_per_probe = _elapsed_ms(lambda: torch.cuda._sleep(probe))
        cycles = probe * max(1, math.ceil(2 * enqueue_ms / max(ms_per_probe, 1e-3)))
        times: list[list[float]] = [[] for _ in fns]
        for r in range(REPS):
            order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
            for k in order:
                times[k].append(_elapsed_ms(
                    lambda: run(fns[k]),
                    before=lambda: torch.cuda._sleep(cycles)) / iters)
    return [statistics.median(t) for t in times]


def flushed_ms(fn: Callable[[], object], device) -> float:
    """Median device milliseconds of one call of ``fn`` with the L2 cache
    evicted first (a ``FLUSH_BYTES`` buffer is overwritten before each
    call, outside the timed events): the cost a caller pays when the
    operands are not already cache-resident."""
    device = _cuda(device)
    with torch.cuda.device(device):
        scrub = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        fn()
        times = [_elapsed_ms(fn, before=lambda: scrub.fill_(1.0))
                 for _ in range(FLUSH_ITERS)]
    return statistics.median(times)


def host_ms(fn: Callable[[], object], device) -> float:
    """Wall milliseconds per call of ``fn`` as its caller sees them:
    ``ITERS`` calls from the host clock, ending in a synchronize (launch
    overhead included)."""
    device = _cuda(device)
    with torch.cuda.device(device):
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / ITERS
