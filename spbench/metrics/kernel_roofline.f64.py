"""``kernel_roofline`` of a float64 cell: the least time of one call
over the device time per call in the traced part of the window (every
device operation, from ``torch.profiler``), in percent.  The least time
is the larger of ``work/<call>.py``'s bytes at the configuration's
element size (its 4-byte count scaled by the size over 4) over the
card's peak bandwidth (``peaks.py``) and its operations over the card's
float64 peak outside the tensor cores (below)."""

import numpy as np

from spbench.peaks import peaks

# FLOP/s in float64 outside the tensor cores, by a fragment of
# ``torch.cuda.get_device_name()``: the NVIDIA H100 SXM data sheet's FP64
# (34 TFLOP/s; 67 is FP64 through the tensor cores, which no kernel here uses)
F64_PEAKS = {
    "h100 80gb hbm3": 34e12,
    "h100 sxm": 34e12,
}


def read(run):
    tr, pk = run.trace, peaks(run.card)
    f64 = next((v for k, v in F64_PEAKS.items() if k in run.card.lower()), None)
    if tr is None or pk is None or f64 is None or tr["calls"] == 0 or tr["device_s"] <= 0:
        return None
    size = np.dtype(run.cell.config["args"].get("dtype", "float32")).itemsize
    least = max(run.work["bytes"] * size / 4 / pk[0], run.work["flops"] / f64)
    return 100.0 * least / (tr["device_s"] / tr["calls"])
