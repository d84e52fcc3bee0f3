"""The share of the process's float64 operator calls that ran the stripe
kernel's f64 staged map: its launches (``trace.launches_by_map()
["staged_f64"]``) over those and the float64 calls that took the
semiring route instead (``trace.semiring_calls()["float64"]``), in
percent.  Both counters count whether the tracer is on or not, since the
process began (the warm-up and the window).  Nothing where the program
has no such counters, or no float64 call was counted."""


def read(run):
    from vbcs_tpu_torch.utils import trace

    by_map = getattr(trace, "launches_by_map", None)
    fell_back = getattr(trace, "semiring_calls", None)
    if by_map is None or fell_back is None:
        return None
    kernel = by_map().get("staged_f64")
    if kernel is None:
        return None
    total = kernel + fell_back().get("float64", 0)
    return 100.0 * kernel / total if total else None
