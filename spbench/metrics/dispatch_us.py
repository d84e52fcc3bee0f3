"""Mean host time from a call's entry to its return, before the
synchronize, over the window's untraced calls (host clock, summed over
thousands of calls)."""


def read(run):
    w = run.window
    return w.dispatch_s / w.dispatch_calls * 1e6 if w.dispatch_calls else None
