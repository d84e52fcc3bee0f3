"""The trace's reduction to busy time, device operations and named idle
gaps, on made-up events."""

import torch

from spbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, kind, dev=CPU):
        self._n, self._s, self._d, self._k, self._dev = name, start, dur, kind, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")


def test_summary():
    events = [
        Ev(trace.WINDOW, 1000, 1000, "user_annotation"),
        Ev(trace.WINDOW, 1000, 1000, "gpu_user_annotation", CUDA),  # not work
        Ev("k1", 900, 300, "kernel", CUDA),     # clipped to 1000-1200
        Ev("k1", 1150, 100, "kernel", CUDA),    # overlaps: busy to 1250
        Ev("memcpy", 1500, 200, "gpu_memcpy", CUDA),
        Ev("k2", 1900, 300, "kernel", CUDA),    # clipped to 1900-2000
        Ev("aten::empty", 1260, 200, "cpu_op"),     # covers gap 1250-1500 most
        Ev("cudaLaunchKernel", 1200, 20, "cuda_runtime"),
        Ev("aten::mul", 1255, 300, "cpu_op"),   # around the empty: not innermost
        Ev("cudaDeviceSynchronize", 1700, 150, "cuda_runtime"),  # gap 1700-1900
    ]
    s = trace.summarize(events, calls=3)
    assert abs(s["window_s"] - 1000e-9) < 1e-18 and s["calls"] == 3
    assert abs(s["busy_s"] - (250 + 200 + 100) * 1e-9) < 1e-18
    assert abs(s["device_s"] - (200 + 100 + 200 + 100) * 1e-9) < 1e-18
    ops = dict(s["device_ops"])
    assert abs(ops["k1"] - 300e-9) < 1e-18 and abs(ops["memcpy"] - 200e-9) < 1e-18
    gaps = dict(s["idle_gaps"])
    # gap 1250-1500: python to 1255, aten::mul to 1260, aten::empty to
    # 1460, aten::mul to 1500; gap 1700-1900: the synchronize to 1850,
    # python to 1900
    assert abs(gaps["aten::empty"] - 200e-9) < 1e-18
    assert abs(gaps["aten::mul"] - 45e-9) < 1e-18
    assert abs(gaps["cudaDeviceSynchronize"] - 150e-9) < 1e-18
    assert abs(gaps["python"] - 55e-9) < 1e-18
    assert abs(sum(gaps.values()) + s["busy_s"] - s["window_s"]) < 1e-18
