"""What the probes share: the card, its name and power limit, the
difference method on CUDA events, and the report line."""

from __future__ import annotations

import subprocess
import time

import torch

from ..utils.profile import roofline
from ..utils.timing import paired_ms

__all__ = ["cuda_device", "card", "warm_up", "marginal_ms", "report"]


def cuda_device() -> torch.device:
    """The current CUDA device; raises ``RuntimeError`` without one (a
    probe's numbers are the card's or nothing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card, and "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(torch.device(device).index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def warm_up(device, seconds: float = 0.5) -> None:
    """Keep the card busy for ``seconds`` (f32 matrix products), so that
    the first variant a probe times does not meet an idle card's clocks."""
    a = torch.randn(2048, 2048, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize(device)


def marginal_ms(run, n_lo: int, n_hi: int, device, iters: int = 5) -> float:
    """Device milliseconds of one more step of ``run(n)`` (``n`` steps):
    the difference of ``n_hi`` and ``n_lo`` steps over ``n_hi - n_lo``,
    both timed by ``paired_ms``, so fixed costs cancel."""
    t_lo, t_hi = paired_ms([lambda: run(n_lo), lambda: run(n_hi)], device,
                           iters=iters)
    return (t_hi - t_lo) / (n_hi - n_lo)


def report(name: str, ms: float, device, nbytes: int, flops: int = 0,
           chunks: int | None = None, nnz: int | None = None,
           unit: str = "call", note: str = "") -> str:
    """One variant's line: us per call (or iteration), ns per chunk, Gnnz/s
    and the share of its bound (``utils.profile.roofline`` of ``nbytes``
    and ``flops`` on ``device``)."""
    r = roofline(int(nbytes), ms * 1e-3, device, flops)
    s = f"{name:44s} {ms * 1e3:9.2f} us/{unit}"
    if chunks:
        s += f"  {ms * 1e6 / chunks:8.0f} ns/chunk"
    if nnz:
        s += f"  {nnz / (ms * 1e6):7.1f} Gnnz/s"
    s += (f"  bound {r.ideal_s * 1e6:.4g} us ({r.bound_by}), "
          f"{100 * r.fraction:.1f}% of it")
    return s + (f"; {note}" if note else "")
