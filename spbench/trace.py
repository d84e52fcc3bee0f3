"""A ``torch.profiler`` capture of a steady part of the window, reduced
in memory to what the metrics read: the device's busy time, the device
operations by total time, and the device's idle gaps named by what the
host was doing across them."""

from __future__ import annotations

import collections

import numpy as np
import torch

WINDOW = "spbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Capture:
    """Start and stop at a sync point; ``summary()`` after the window."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = torch.profiler.record_function(WINDOW)
        self.calls = 0

    def start(self):
        self.prof.__enter__()
        self.mark.__enter__()

    def stop(self, calls: int):
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.calls = calls

    def summary(self) -> dict:
        return summarize(self.prof.profiler.kineto_results.events(), self.calls)


def _is_device(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation())


def summarize(events, calls: int) -> dict:
    """``busy_s`` (the union of device operations inside the window),
    ``window_s``, ``device_s`` (their summed durations), ``calls`` (the
    calls made inside), ``device_ops`` and ``idle_gaps`` (at most 10
    ``[name, seconds]`` each, largest first)."""
    win, dev, host = None, [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.name() == WINDOW and e.device_type() != torch.autograd.DeviceType.CUDA:
            win = (s, s + d)
        elif _is_device(e):
            dev.append((s, s + d, e.name()))
        elif e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((s, s + d, e.name()))
    if win is None:
        raise RuntimeError("the trace holds no window mark")
    w0, w1 = win
    ops = collections.Counter()
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            ops[name] += (e - s) * 1e-9
            spans.append((s, e))
    spans.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e in spans:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "device_s": sum(ops.values()), "calls": calls,
            "device_ops": [[n, v] for n, v in ops.most_common(10)],
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> list:
    """Sum the idle time by what the host was doing: each instant of a
    gap goes to the shortest host operation around it (the innermost),
    or to 'python' where none is (the interpreter between operations)."""
    by = collections.Counter()
    if not gaps:
        return []
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.int64)
    longest = max((h[1] - h[0] for h in host), default=0)
    for g0, g1 in gaps:
        lo = int(np.searchsorted(starts, g0 - longest, side="left"))
        hi = int(np.searchsorted(starts, g1, side="right"))
        around = [(max(s, g0), min(e, g1), e - s, name)
                  for s, e, name in host[lo:hi] if min(e, g1) > max(s, g0)]
        cuts = sorted({g0, g1, *(a for a, _, _, _ in around),
                       *(b for _, b, _, _ in around)})
        for a, b in zip(cuts, cuts[1:]):
            inner = [(d, name) for s, e, d, name in around if s <= a and e >= b]
            by[min(inner)[1] if inner else "python"] += (b - a) * 1e-9
    return [[n, v] for n, v in by.most_common(10)]
