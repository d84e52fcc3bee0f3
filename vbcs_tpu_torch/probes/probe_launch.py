"""Probe: the fixed cost of one launch on the card, and of the pad glue.

Port of ``bench_tools/probe_launch.py``.  The TPU probe runs a step
``N`` times inside one jit'ed ``fori_loop`` and reports the marginal time
of a step (the difference of ``N = 20`` and ``220``) for four steps:

* ``one``: ``add_one(x) * 0.999`` — one launch of the smallest kernel,
  ``o = x + 1`` on f32 ``[8, 128]`` (``csrc/probe_launch.cu``);
* ``two``: ``add_one(add_one(x)) * 0.999``;
* ``elementwise``: ``x * 0.999 + 1`` (torch ops; no kernel of the port);
* ``pad``: ``x`` of 320,000 padded into 327,680 zeros and sliced back,
  times 0.999 (torch ops).

On the card each step runs as eager launches from Python, timed on the
caller's clock (the host paces them: a queue of hundreds of launches
fills), and as a CUDA graph of the same ``N`` steps replayed, the
counterpart of the loop inside one jit, timed on the device; both by the
difference of ``N_LO`` and ``N_HI`` steps (10 and 60: on the card longer
loops add nothing).  Beside them: one ``add_one`` launch through its
ctypes wrapper (device time back to back, and the caller's clock), the
parts of that call path alone (the C launcher with its arguments ready,
the stream handle, the device context, the output allocation), one
``tr_spmv`` on a one-stripe pack (the launch floor of the port's real
call path), and ``torch.add(x, 1.0)`` (the library yardstick).

Run on the card:  python -m vbcs_tpu_torch.probes.probe_launch
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..api import vbc1d
from ..formats.device import VBC1DDevice
from ..ops import _lib
from ..ops.trspmv import tr_spmv
from ..utils.timing import host_ms, paired_ms
from ._common import card, cuda_device, marginal_ms, report, warm_up

__all__ = ["add_one", "add_one_plain", "inputs", "step", "chained", "graph",
           "STEPS", "run", "main"]

SHAPE = (8, 128)
PAD_N, PAD_TO = 320_000, 327_680
N_LO, N_HI = 10, 60
# step -> the TPU probe's line
STEPS = {"one": "tiny pallas launch", "two": "two tiny pallas launches",
         "elementwise": "xla elementwise iter", "pad": "pad+unpad iter"}


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous f32 ``x``: the CUDA kernel on a CUDA
    tensor, :func:`add_one_plain` on a CPU tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32, got {x.dtype}")
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no launch probe kernel for device {x.device}")
    out = torch.empty_like(x)
    _lib.launch(add_one, "vbcs_probe_add_one", x.device, x.numel(), x.data_ptr(),
                out.data_ptr(), name="probe add_one")
    return out


add_one.launches = 0


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`add_one`."""
    return x + 1.0


def inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU probe's inputs, on the CPU: ones ``[8, 128]`` and ones
    ``[320,000]``."""
    return torch.ones(SHAPE), torch.ones(PAD_N)


def step(kind: str, x: torch.Tensor) -> torch.Tensor:
    """One step of the loop ``kind`` (see the module docstring)."""
    if kind == "one":
        return add_one(x) * 0.999
    if kind == "two":
        return add_one(add_one(x)) * 0.999
    if kind == "elementwise":
        return x * 0.999 + 1.0
    if kind == "pad":
        xp = torch.zeros(PAD_TO, dtype=x.dtype, device=x.device)
        xp[:PAD_N] = x
        return xp[:PAD_N] * 0.999
    raise ValueError(f"unknown step {kind!r}")


def chained(kind: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` steps of ``kind`` from ``x``."""
    for _ in range(n):
        x = step(kind, x)
    return x


def graph(kind: str, x: torch.Tensor, n: int) -> torch.cuda.CUDAGraph:
    """``n`` steps of ``kind`` from the CUDA tensor ``x``, captured in a
    CUDA graph (run once eagerly first, so that nothing is loaded during
    the capture)."""
    chained(kind, x, n)
    torch.cuda.synchronize(x.device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        chained(kind, x, n)
    return g


def run(device) -> dict:
    """Per-step times (ms) of each step on the CUDA ``device``: eager on
    the caller's clock (``wall_ms``) and a CUDA graph's replay on the
    device (``graph_ms``); and the ctypes path's floors, its parts and
    the library call."""
    x0, xb = (t.to(device) for t in inputs())
    out = {}
    for kind in STEPS:
        x = xb if kind == "pad" else x0
        graphs = {n: graph(kind, x, n) for n in (N_LO, N_HI)}
        walls = [host_ms(lambda n=n: chained(kind, x, n), device) for n in (N_LO, N_HI)]
        out[kind] = {
            "wall_ms": (walls[1] - walls[0]) / (N_HI - N_LO),
            "graph_ms": marginal_ms(lambda n: graphs[n].replay(), N_LO, N_HI, device)}
    tiny = VBC1DDevice.from_host(vbc1d(sp.identity(8, np.float32, format="csc"), 8),
                                 device)
    x8 = torch.ones(8, device=device)
    launch, plain, library, spmv = paired_ms(
        [lambda: add_one(x0), lambda: add_one_plain(x0),
         lambda: torch.add(x0, 1.0), lambda: tr_spmv(tiny, x8)], device)
    lib, o = _lib.load(), torch.empty_like(x0)
    args = (x0.numel(), x0.data_ptr(), o.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    out["add_one"] = {"ms": launch, "plain_ms": plain, "library_ms": library,
                      "wall_ms": host_ms(lambda: add_one(x0), device),
                      "bytes": 2 * x0.numel() * 4}
    def device_context():
        with torch.cuda.device(device):
            pass

    # the caller's clock of the call path's parts and of the library call
    out["parts_wall_ms"] = {
        "C launcher": host_ms(lambda: lib.vbcs_probe_add_one(*args), device),
        "stream handle": host_ms(
            lambda: torch.cuda.current_stream(device).cuda_stream, device),
        "device context": host_ms(device_context, device),
        "empty_like": host_ms(lambda: torch.empty_like(x0), device),
        "torch.add": host_ms(lambda: torch.add(x0, 1.0), device)}
    out["tr_spmv_one_stripe"] = {"ms": spmv,
                                 "wall_ms": host_ms(lambda: tr_spmv(tiny, x8), device)}
    return out


def print_record(r, device) -> None:
    for kind, tpu_name in STEPS.items():
        s = r[kind]
        print(f"{tpu_name:44s} eager {s['wall_ms'] * 1e3:8.2f} us/step on the "
              f"caller's clock; CUDA graph {s['graph_ms'] * 1e3:8.2f} us/step on "
              f"the device", flush=True)
    a = r["add_one"]
    print(report("add_one launch (ctypes wrapper)", a["ms"], device, a["bytes"],
                 note=f"caller's clock {a['wall_ms'] * 1e3:.2f} us/call; plain "
                 f"{a['plain_ms'] * 1e3:.2f} us; library (torch.add) "
                 f"{a['library_ms'] * 1e3:.2f} us"), flush=True)
    print(f"{'add_one call path, by part':44s} "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in r["parts_wall_ms"].items())
          + " us/call on the caller's clock", flush=True)
    t = r["tr_spmv_one_stripe"]
    print(f"{'tr_spmv, one-stripe pack (ctypes path)':44s} {t['ms'] * 1e3:9.2f} "
          f"us/call on the device, {t['wall_ms'] * 1e3:.2f} us/call on the caller's "
          f"clock", flush=True)


def main() -> None:
    device = cuda_device()
    print(card(device), flush=True)
    warm_up(device)
    print_record(run(device), device)


if __name__ == "__main__":
    main()
