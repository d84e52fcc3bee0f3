"""Seconds of ``VBCOperator.from_csc`` (plan, pack, auto-RCM, the copy
to the card), host clock, in set-up."""


def read(run):
    return run.phases.get("from_csc_s")
