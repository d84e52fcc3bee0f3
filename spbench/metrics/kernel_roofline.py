"""The least time of one call (``work/<call>.py``: its bytes over the
card's peak bandwidth or its operations over its peak rate, whichever is
larger) over the device time per call in the traced part of the window
(every device operation, from ``torch.profiler``), in percent."""

from spbench.peaks import peaks


def read(run):
    tr, pk = run.trace, peaks(run.card)
    if tr is None or pk is None or tr["calls"] == 0 or tr["device_s"] <= 0:
        return None
    least = max(run.work["bytes"] / pk[0], run.work["flops"] / pk[1])
    return 100.0 * least / (tr["device_s"] / tr["calls"])
