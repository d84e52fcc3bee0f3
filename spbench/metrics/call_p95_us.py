"""The 95th percentile of every request's time in the window, on the
host clock: from the call's entry to the return of the synchronize that
ends the request, so the kernel, the dispatch and the host's round trip
through the synchronize are all in it."""

import numpy as np


def read(run):
    lat = run.window.latencies_us
    return float(np.percentile(lat, 95)) if lat else None
