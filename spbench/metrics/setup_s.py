"""Seconds from process start to the first timed call: imports, the
card's start, the kernel library's load (its build on a checkout's first
run), generation, ``from_csc``, the operands, the warm-up."""


def read(run):
    return run.setup_s
