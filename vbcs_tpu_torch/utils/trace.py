"""The port's tracer: named spans and counters on the path a user runs.

Off unless :func:`enable` is called.  Off, :func:`span` returns one
shared no-op context (a branch on a module flag: no clock read, no
allocation, no profiler call) and :func:`count` returns at once.  On,
each span appends one record to a list in memory as it closes — its
name, start and end, its parent span and the call it belongs to (a span
opened with none open on its thread starts a new call; the spans inside
it share its id) — and, while a ``torch.profiler`` session is active,
opens a profiler range of the same name, so the port's spans sit in the
profiler's timeline beside the kernels they launch.  Records are turned
into plain data only when read (:func:`snapshot`).

Stamps are Unix-epoch nanoseconds (``time.time_ns()``), the clock of the
profiler's host events.  A span never synchronizes the device: a span
around a launch holds the host's part of it.

Span names are fixed strings at each site:

* ``from_csc`` (the root of an operator's ``from_csc``), ``plan.dp``
  (``pack_stripe``), ``plan.pack`` (``pack_1dvbc``), ``plan.badness``
  (``window_badness``), ``plan.rcm`` (``rcm_symmetric``),
  ``plan.transpose`` (``from_csc``'s ``A.transpose()``), ``plan.upload``
  (an operator's ``from_host``: the packs and the permutation checked
  and copied to the device);
* ``lib.load`` (the kernel library's first load, its build inside);
* ``op.tr_mul``, ``op.mul``, ``op.tr_mul_mat``, ``op.mul_mat``,
  ``op.tr_mul_chain`` (the root of each operator call), ``op.route``
  (the first build of an operator's routed format), ``op.check`` (the
  operand checks), ``op.alloc`` (the output's allocation), ``op.launch``
  (the launcher's ctypes call and its error check), ``op.semiring`` (a
  call's product on the semiring route, ``ops/semiring.py``).

Besides the tracer's own counters (:func:`count`, on only while it is),
this module owns the always-on counters, which count whether the tracer
is on or not, from the process's start, each under one lock: the layers
above add to them with :func:`tally` and read them with
:func:`launches_by_map` (the stripe TrSpMV's launches by the thread map
each took, ``ops/trspmv.py``, and the ordered scatter's two launches,
``ops/ordered.py``), :func:`semiring_calls` (the operator calls that
took the semiring route, by dtype, ``operator.py``),
:func:`reorder_choices` (``VBCOperator.from_csc``'s auto-RCM decisions
by the packs kept) and :func:`forward_choices` (its choice of the pack
the forward products run on).  :func:`launches` sums the ``.launches``
counters of the operator's per-call kernels (``ops.CALL_LAUNCHERS``,
which ``_lib``'s launcher increments): the one read of ``ops`` left
here.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

__all__ = ["enable", "disable", "enabled", "span", "count", "snapshot", "reset",
           "summary", "tally", "launches", "launches_by_map", "semiring_calls",
           "reorder_choices", "forward_choices"]

_on = False
_NULL = contextlib.nullcontext()
# one (open entry, end_ns) a closed span, appended as it closes (the entry
# is what the thread's stack held: _Thread.open); seq numbers spans in the
# order opened (atomic across threads), a call's seq is its root span's
_records: list = []
_seq = itertools.count()
_counters: dict = {}
_count_lock = threading.Lock()
# the always-on counters (tally), by name: counted whether the tracer is
# on or not, since the process began; reset() keeps them
_tallies = {"launches_by_map": {"quad": 0, "staged": 0, "staged_f64": 0,
                                "ordered_products": 0, "ordered_rows": 0},
            "semiring_calls": {}, "reorder_choices": {"natural": 0, "rcm": 0},
            "forward_choices": {"A": 0, "A.T": 0}}

_now = time.time_ns
_profiling = torch.autograd._profiler_enabled
_fast_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _Thread(threading.local):
    def __init__(self):
        # this thread's open spans: (name, seq, call seq, parent seq,
        # start_ns, profiler range or None)
        self.open = []


_thread = _Thread()


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording (what was recorded is kept until :func:`reset`)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Close:
    """What :func:`span` returns when on: one shared object, whose exit
    closes the calling thread's innermost open span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        entry = _thread.open.pop()
        _records.append((entry, _now()))
        if entry[5] is not None:
            entry[5].__exit__(kind, value, tb)
        return False


_CLOSE = _Close()


def span(name: str):
    """``with span(name):`` records ``name`` from entry to exit when the
    tracer is on, and does nothing when it is off.  The span opens when
    ``span`` is called: use it only as the expression of a ``with``."""
    if not _on:
        return _NULL
    stack = _thread.open
    seq = next(_seq)
    if stack:
        top = stack[-1]
        call, parent = top[2], top[1]
    else:
        call, parent = seq, -1
    rng = None
    if _profiling():
        rng = (_fast_range(name) if _fast_range is not None
               else torch.profiler.record_function(name))
        rng.__enter__()
    stack.append((name, seq, call, parent, _now(), rng))
    return _CLOSE


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when the tracer is on."""
    if not _on:
        return
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def reset() -> None:
    """Forget every span and counter recorded so far; the calling thread
    must have no span open."""
    global _seq
    if _thread.open:
        raise RuntimeError("reset() inside an open span")
    _records.clear()
    _counters.clear()
    _seq = itertools.count()


def snapshot() -> dict:
    """What was recorded so far, as plain data: ``{"spans": [...],
    "counters": {name: n}}``, the spans in the order opened, each a dict
    of ``name``, ``start_ns``, ``end_ns`` (None for a span the calling
    thread has open), ``parent`` (its parent's index in the list, -1 for
    none) and ``call`` (the call's id: 0, 1, ... in the order the calls
    began)."""
    recs = sorted(_records + [(entry, None) for entry in _thread.open],
                  key=lambda r: r[0][1])
    index = {entry[1]: i for i, (entry, _) in enumerate(recs)}
    calls: dict = {}
    spans = [{"name": name, "start_ns": t0, "end_ns": t1,
              "parent": index.get(parent, -1),
              "call": calls.setdefault(call, len(calls))}
             for (name, _, call, parent, t0, _), t1 in recs]
    with _count_lock:
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def summary(spans: list, keep=None) -> dict:
    """``{name: {"count", "total_s", "self_s"}}`` over the closed spans of
    a snapshot's ``spans`` that ``keep(span)`` accepts (all by default);
    a span's self time is its own less that of its closed children."""
    inner = [0] * len(spans)
    for s in spans:
        if s["end_ns"] is not None and s["parent"] >= 0:
            inner[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: dict = {}
    for s, kids in zip(spans, inner):
        if s["end_ns"] is None or (keep is not None and not keep(s)):
            continue
        d = s["end_ns"] - s["start_ns"]
        e = out.setdefault(s["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
        e["count"] += 1
        e["total_s"] += d * 1e-9
        e["self_s"] += (d - kids) * 1e-9
    return out


def launches() -> int:
    """Kernel launches of the operator's per-call kernels since the
    process began (the sum of their ``.launches`` counters)."""
    from ..ops import CALL_LAUNCHERS

    return sum(f.launches for f in CALL_LAUNCHERS)


def tally(counter: str, key: str) -> None:
    """Add one to ``key`` of the always-on counter ``counter``, whether
    the tracer is on or not: ``"launches_by_map"`` (a stripe TrSpMV
    launch, by thread map, or a launch of the ordered scatter),
    ``"semiring_calls"`` (an operator call on the semiring route, by its
    product's dtype), ``"reorder_choices"`` (an auto-RCM decision, by the
    packs kept) or ``"forward_choices"`` (the pack chosen for the forward
    products)."""
    with _count_lock:
        counts = _tallies[counter]
        counts[key] = counts.get(key, 0) + 1


def _tally_of(counter: str) -> dict:
    with _count_lock:
        return dict(_tallies[counter])


def launches_by_map() -> dict:
    """Launches of the stripe TrSpMV kernel since the process began, by
    the thread map the launcher took from the format (``"quad"``, the
    float4 map; ``"staged"``, a run of stripes a block; both f32;
    ``"staged_f64"``, the staged map in f64), and of the ordered scatter
    by launch (``"ordered_products"``, a stripe of A's pack a group;
    ``"ordered_rows"``, the rows of Y with no block or several, or every
    row below 8 columns)."""
    return _tally_of("launches_by_map")


def semiring_calls() -> dict:
    """Operator calls that took the semiring route (``ops/semiring.py``)
    since the process began, by the dtype of their product (``"float64"``,
    ``"int32"``, ...; a dtype no call had is absent).  Beside
    :func:`launches_by_map` it tells an f64 call that reached the kernel
    from one that fell back."""
    return _tally_of("semiring_calls")


def reorder_choices() -> dict:
    """``VBCOperator.from_csc``'s auto-RCM decisions since the process
    began, ``{"natural": n, "rcm": n}``: one a ``reorder="auto"`` call on a
    square matrix of more than 1,024 rows (a smaller or non-square one is
    never relabeled, and no decision is made)."""
    return _tally_of("reorder_choices")


def forward_choices() -> dict:
    """``VBCOperator.from_csc``'s choices of the pack the forward products
    (``mul_mat``, and ``mul`` where no A.T pack is held) run on, since
    the process began: ``{"A": n, "A.T": n}``, one an f32 operator asked
    for the forward direction (``"A"``: the ordered scatter on A's pack;
    ``"A.T"``: the gather on A.T's).  An operator of another dtype keeps
    A.T's pack unasked."""
    return _tally_of("forward_choices")
