"""Roofline accounting on a CUDA card.

Port of ``vbcs_tpu/utils/profile.py``.  :func:`stream_bytes` counts the
bytes one TrSpMV over a device format must move (its arrays, x and y),
:func:`roofline` turns bytes and operations into the least time the card
could take and the share of it a measured time reaches.  The peaks come
from the card's name and its data sheet; a CPU device or a card not in the table raises
(a host-memory guess is no device metric).
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.device import ScatterDevice, VBC1DDevice, VBC2DDevice

__all__ = ["hbm_bandwidth", "f32_flops", "stream_bytes", "roofline", "Roofline"]

# data sheets (SXM parts, dense, outside the tensor cores for f32):
# card-name fragment -> (device-memory bytes/s, f32 FLOP/s)
_PEAKS = {
    "h100 80gb hbm3": (3.35e12, 67e12),  # H100 SXM
    "h100 sxm": (3.35e12, 67e12),
    "h200": (4.8e12, 67e12),
}


def _peaks(device) -> tuple[float, float]:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no device peaks for {device}: the roofline needs a "
                         f"CUDA card")
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS.items():
        if key in name.lower():
            return peaks
    raise ValueError(f"no data-sheet peaks for the card {name!r}")


def hbm_bandwidth(device) -> float:
    """Peak device-memory bytes/s of the CUDA ``device`` (data sheet)."""
    return _peaks(device)[0]


def f32_flops(device) -> float:
    """Peak f32 FLOP/s of the CUDA ``device`` outside the tensor cores."""
    return _peaks(device)[1]


def stream_bytes(fmt) -> int:
    """Bytes one TrSpMV over a device format must move: the format's
    arrays (``VBC1DDevice``, ``VBC2DDevice`` or ``ScatterDevice``), x and
    y."""
    if not isinstance(fmt, (VBC1DDevice, VBC2DDevice, ScatterDevice)):
        raise TypeError(f"no stream bytes for {type(fmt).__name__}")
    return int(fmt.nbytes + 4 * (fmt.m + fmt.n))


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes_moved: int
    flops: int
    bandwidth: float
    flop_rate: float
    ideal_s: float  # the larger of bytes / bandwidth and flops / flop_rate
    bound_by: str  # "bytes" or "operations"
    measured_s: float | None
    fraction: float | None  # ideal / measured

    def __str__(self):
        s = (f"{self.bytes_moved / 1e6:.2f} MB @ {self.bandwidth / 1e9:.0f} GB/s, "
             f"{self.flops / 1e6:.2f} MFLOP @ {self.flop_rate / 1e12:.0f} TFLOP/s "
             f"-> ideal {self.ideal_s * 1e6:.2f} us ({self.bound_by})")
        if self.measured_s is not None:
            s += (f"; measured {self.measured_s * 1e6:.2f} us "
                  f"({100 * self.fraction:.1f}% of roofline)")
        return s


def roofline(work, measured_s: float | None = None, device="cuda",
             flops: int = 0) -> Roofline:
    """Roofline of ``work`` on the CUDA ``device``: a device format (its
    :func:`stream_bytes` and 2 operations a stored value) or a byte count
    with ``flops`` operations, optionally against a measured time."""
    if isinstance(work, int):
        nbytes = work
    else:
        nbytes = stream_bytes(work)
        flops = 2 * work.val.numel()
    bw, rate = _peaks(device)
    t_bytes, t_ops = nbytes / bw, flops / rate
    ideal = max(t_bytes, t_ops)
    return Roofline(
        bytes_moved=int(nbytes), flops=int(flops), bandwidth=bw, flop_rate=rate,
        ideal_s=ideal, bound_by="bytes" if t_bytes >= t_ops else "operations",
        measured_s=measured_s,
        fraction=(ideal / measured_s) if measured_s else None)

