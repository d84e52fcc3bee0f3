"""Nonzero-vector products completed in the window over its seconds
(host clock over the whole window, which ends in a synchronize), in
billions a second."""


def read(run):
    w = run.window
    return run.work["products"] * w.calls / w.elapsed_s / 1e9
