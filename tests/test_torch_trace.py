"""The port's tracer (``vbcs_tpu_torch/utils/trace.py``): off, nothing
is recorded and no profiler function or clock is called; on, the
set-up's span tree under ``from_csc``, one call id an operator call, self
times, the snapshot as plain data, threads, and the profiler's clock.
The card test checks the launch spans and the launch counter."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch import ops
from vbcs_tpu_torch.utils import trace

# auto-RCM on both directions: A's and A.T's packs, RCM, the relabeled
# matrix's two packs (kept: they store fewer bytes), the copy
PLAN = ["plan.dp", "plan.pack", "plan.transpose", "plan.dp", "plan.pack", "plan.rcm",
        "plan.dp", "plan.pack", "plan.transpose", "plan.dp", "plan.pack", "plan.upload"]


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def relabeled_band(n=8192, seed=0):
    """A band of half-width 3, symmetrically permuted at random: square,
    over auto-RCM's 1,024 rows, and scattered enough that it relabels."""
    rng = np.random.default_rng(seed)
    A = sp.diags([np.ones(n - abs(k)) for k in range(-3, 4)], list(range(-3, 4)),
                 shape=(n, n), format="csc", dtype=np.float32)
    A.data[:] = rng.standard_normal(A.nnz).astype(np.float32)
    p = rng.permutation(n)
    return A[p][:, p].tocsc()


@pytest.fixture(scope="module")
def band():
    return relabeled_band()


def operator(A, device="cpu"):
    return vt.VBCOperator.from_csc(A, W=8, directions="both", reorder="auto",
                                   device=device)


# an operator call: its name, the root span it records, a call of it
CALLS = [
    ("tr_mul", "op.tr_mul", lambda op, x, X: op.tr_mul(x, 2.0, 0.5, x)),
    ("mul", "op.mul", lambda op, x, X: op.mul(x)),
    ("tr_mul_mat", "op.tr_mul_mat", lambda op, x, X: op.tr_mul_mat(X)),
    ("mul_mat", "op.mul_mat", lambda op, x, X: op.mul_mat(X)),
    ("tr_mul_chain", "op.tr_mul_chain", lambda op, x, X: op.tr_mul_chain(x, 3, 0.5)),
]


def operands(n, device="cpu"):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, generator=g).to(device)
    X = torch.randn(n, 4, generator=g).to(device)
    return x, X


def test_off_records_nothing_and_calls_no_profiler_function(band, monkeypatch):
    called = []

    def spy(name, fn):
        def wrapped(*a, **k):
            called.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trace, "_profiling", spy("enabled", trace._profiling))
    monkeypatch.setattr(trace, "_now", spy("clock", trace._now))
    if trace._fast_range is not None:
        monkeypatch.setattr(trace, "_fast_range", spy("fast", trace._fast_range))
    monkeypatch.setattr(torch.profiler, "record_function",
                        spy("record_function", torch.profiler.record_function))
    assert not trace.enabled()
    op = operator(band)
    assert op.row_perm is not None
    x, X = operands(op.n)
    for _, _, call in CALLS:
        call(op, x, X)
    trace.count("anything")
    assert called == []
    assert trace.snapshot() == {"spans": [], "counters": {}}
    assert trace.span("op.mul") is trace.span("plan.dp")  # the one shared no-op


def test_set_up_tree_under_from_csc(band):
    trace.enable()
    op = operator(band)
    trace.disable()
    assert op.row_perm is not None
    spans = trace.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["from_csc"] + PLAN
    root = spans[0]
    assert root["parent"] == -1
    for s in spans[1:]:
        assert s["parent"] == 0 and s["call"] == root["call"]
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
    starts = [s["start_ns"] for s in spans[1:]]
    assert starts == sorted(starts)


@pytest.mark.parametrize("name,root,call", CALLS, ids=[c[0] for c in CALLS])
def test_each_call_is_one_call_id(band, name, root, call):
    op = operator(band)
    x, X = operands(op.n)
    trace.enable()
    for _ in range(3):
        call(op, x, X)
    trace.disable()
    spans = trace.snapshot()["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert [spans[i]["name"] for i in roots] == [root] * 3
    assert [spans[i]["call"] for i in roots] == [0, 1, 2]
    for s in spans:
        if s["parent"] != -1:
            assert s["call"] == spans[s["parent"]]["call"]
    kids = [[s["name"] for s in spans if s["call"] == c][1:] for c in range(3)]
    # the first call builds the routed format (a tr_mul or mul on an
    # auto-RCM operator: the natural view, then the route over it); the
    # CPU's plain versions check their operands and launch nothing (the
    # chain's checks are the operator's, in its root)
    first, check = {"tr_mul": (["op.route", "op.route", "op.check"], ["op.check"]),
                    "mul": (["op.route", "op.route", "op.check"], ["op.check"]),
                    "tr_mul_mat": (["op.route", "op.check"], ["op.check"]),
                    "mul_mat": (["op.route", "op.check"], ["op.check"]),
                    "tr_mul_chain": ([], [])}[name]
    assert kids == [first, check, check]
    assert all(spans[s["parent"]]["name"] == root for s in spans if s["parent"] != -1)


def fake_clock(monkeypatch, stamps):
    it = iter(stamps)
    monkeypatch.setattr(trace, "_now", lambda: next(it))


def test_self_time_of_nested_spans(monkeypatch):
    # outer [0, 100]: a [10, 40] holding b [15, 25], then c [50, 90]
    fake_clock(monkeypatch, [0, 10, 15, 25, 40, 50, 90, 100])
    trace.enable()
    with trace.span("outer"):
        with trace.span("a"):
            with trace.span("b"):
                pass
        with trace.span("c"):
            pass
    got = trace.summary(trace.snapshot()["spans"])
    want = {"outer": (100, 100 - 30 - 40), "a": (30, 30 - 10), "b": (10, 10),
            "c": (40, 40)}
    assert set(got) == set(want)
    for name, (total, own) in want.items():
        assert got[name]["count"] == 1
        assert got[name]["total_s"] == pytest.approx(total * 1e-9)
        assert got[name]["self_s"] == pytest.approx(own * 1e-9)
    kept = trace.summary(trace.snapshot()["spans"], keep=lambda s: s["name"] != "a")
    assert set(kept) == {"outer", "b", "c"} and kept["outer"]["self_s"] == pytest.approx(30e-9)


def test_snapshot_is_plain_data(monkeypatch):
    fake_clock(monkeypatch, [5, 6, 7, 8, 9, 10, 11, 12])
    trace.enable()
    with trace.span("op.mul"):
        with trace.span("op.check"):
            trace.count("seen", 2)
        trace.count("seen")
        with trace.span("op.launch"):
            open_snap = trace.snapshot()
    snap = trace.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap == {"spans": [
        {"name": "op.mul", "start_ns": 5, "end_ns": 10, "parent": -1, "call": 0},
        {"name": "op.check", "start_ns": 6, "end_ns": 7, "parent": 0, "call": 0},
        {"name": "op.launch", "start_ns": 8, "end_ns": 9, "parent": 0, "call": 0}],
        "counters": {"seen": 3}}
    # spans still open when read have no end
    assert [s["end_ns"] for s in open_snap["spans"]] == [None, 7, None]
    with trace.span("x"), pytest.raises(RuntimeError, match="open span"):
        trace.reset()


def test_threads_nest_apart():
    """Spans of several threads at once each find their own parent."""
    threads, rounds = 16, 200
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    names = [(f"t{i}.outer", f"t{i}.inner") for i in range(threads)]

    def work(outer, inner):
        for _ in range(rounds):
            with trace.span(outer):
                with trace.span(inner):
                    pass

    try:
        ts = [threading.Thread(target=work, args=n) for n in names]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = trace.snapshot()["spans"]
    assert len(spans) == 2 * threads * rounds
    roots = {s["call"] for s in spans if s["parent"] == -1}
    assert len(roots) == threads * rounds
    for s in spans:
        if s["name"].endswith(".inner"):
            parent = spans[s["parent"]]
            assert parent["name"] == s["name"].replace("inner", "outer")
            assert parent["call"] == s["call"]


def test_a_span_shares_the_profiler_clock():
    """Inside a ``torch.profiler`` session a span opens a profiler range
    of its name; the two agree to 90% of a span of 5 ms or more."""
    trace.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("plan.dp"):
            time.sleep(0.02)
    s = trace.snapshot()["spans"][0]
    found = [e for e in prof.profiler.kineto_results.events() if e.name() == "plan.dp"]
    assert len(found) == 1
    p0 = found[0].start_ns()
    p1 = p0 + found[0].duration_ns()
    overlap = min(p1, s["end_ns"]) - max(p0, s["start_ns"])
    assert s["end_ns"] - s["start_ns"] >= 5e6
    assert overlap >= 0.9 * max(p1 - p0, s["end_ns"] - s["start_ns"])


def test_launches_sums_the_per_call_launchers(monkeypatch):
    assert ops.CALL_LAUNCHERS == (vt.tr_spmv, vt.tr_spmv_scatter, vt.tr_spmv_2d,
                                  vt.tr_spmm, vt.tr_spmv_chain, vt.mul_ordered)
    for i, f in enumerate(ops.CALL_LAUNCHERS):
        monkeypatch.setattr(f, "launches", 10 ** i)
    assert trace.launches() == 111111


@pytest.fixture(scope="module")
def band64(band):
    """The band in f64: an operator whose f64 calls take the stripe
    kernel's f64 map (its plain version on the CPU)."""
    return operator(band.astype(np.float64))


def test_semiring_span_opens_only_on_that_route(band64):
    """``op.semiring`` wraps the semiring route's product, under the
    call's root span, and opens on no other route: not on an f64 call that
    the stripe route takes, nor on an f32 one."""
    op = band64
    x = torch.randn(op.n, dtype=torch.float64)
    op.mul(x)  # the routed format built
    op.mul(x.float())  # the semiring format built
    trace.enable()
    op.mul(x)
    op.tr_mul(x, 2.0, 0.5, x)
    trace.disable()
    assert "op.semiring" not in {s["name"] for s in trace.snapshot()["spans"]}
    trace.reset()
    trace.enable()
    op.mul(x.float())  # a mixed pair: the semiring route, in f32
    op.tr_mul_chain(x, 2, 0.5)  # the chain in f64
    op.mul_mat(x[:, None].repeat(1, 2))  # the SpMM in f64
    trace.disable()
    spans = trace.snapshot()["spans"]
    semi = [s for s in spans if s["name"] == "op.semiring"]
    assert [spans[s["parent"]]["name"] for s in semi] == ["op.mul", "op.tr_mul_chain",
                                                          "op.mul_mat"]
    assert [s["call"] for s in semi] == [0, 1, 2]


def test_semiring_counter_counts_with_the_tracer_off_or_on(band64):
    op = band64
    x = torch.randn(op.n, dtype=torch.float64)
    for on in (False, True):
        if on:
            trace.enable()
        before = trace.semiring_calls()
        op.mul(x.float())
        op.tr_mul_chain(x, 2)
        op.mul(x)  # the stripe route: no semiring call
        after = trace.semiring_calls()
        assert after.get("float32", 0) == before.get("float32", 0) + 1
        assert after.get("float64", 0) == before.get("float64", 0) + 1
        trace.disable()
    assert trace.snapshot()["counters"] == {}  # not the tracer's counters


def test_always_on_counters_count_through_tally(band, monkeypatch):
    """``trace.tally`` adds one to a key of one of the four always-on
    counters, with the tracer off or on, outside the tracer's counters;
    the readers return copies under their keys; the operator counts its
    auto-RCM decisions, its choices of the forward products' pack and its
    semiring calls through it."""
    assert set(trace.launches_by_map()) == {"quad", "staged", "staged_f64",
                                            "ordered_products", "ordered_rows"}
    assert set(trace.reorder_choices()) == {"natural", "rcm"}
    assert set(trace.forward_choices()) == {"A", "A.T"}
    for on in (False, True):
        if on:
            trace.enable()
        maps, semi, rcm, fw = (trace.launches_by_map(), trace.semiring_calls(),
                               trace.reorder_choices(), trace.forward_choices())
        trace.tally("launches_by_map", "staged_f64")
        trace.tally("semiring_calls", "int32")
        trace.tally("reorder_choices", "natural")
        trace.tally("forward_choices", "A")
        assert trace.launches_by_map() == {**maps, "staged_f64": maps["staged_f64"] + 1}
        assert trace.semiring_calls() == {**semi, "int32": semi.get("int32", 0) + 1}
        assert trace.reorder_choices() == {**rcm, "natural": rcm["natural"] + 1}
        assert trace.forward_choices() == {**fw, "A": fw["A"] + 1}
        trace.launches_by_map()["quad"] = -1  # a copy
        assert trace.launches_by_map()["quad"] != -1
        trace.disable()
    assert trace.snapshot()["counters"] == {}
    seen = []
    monkeypatch.setattr(trace, "tally", lambda counter, key: seen.append((counter, key)))
    op = operator(band)
    op.mul(torch.randn(op.n, dtype=torch.float64))  # f32 matrix, f64 x: semiring
    assert seen == [("reorder_choices", "rcm"), ("forward_choices", "A.T"),
                    ("semiring_calls", "float64")]


def test_off_cost_of_a_span_is_unchanged(band64, monkeypatch):
    """Off, the new span is the one shared no-op like every other, and a
    semiring call calls no clock and no profiler function."""
    called = []
    monkeypatch.setattr(trace, "_now", lambda: called.append("clock") or 0)
    monkeypatch.setattr(trace, "_profiling", lambda: called.append("profiling") or False)
    assert trace.span("op.semiring") is trace.span("op.mul") is trace._NULL
    x = torch.randn(band64.n, dtype=torch.float64)
    band64.mul(x.float())
    band64.mul(x)
    assert called == [] and trace.snapshot() == {"spans": [], "counters": {}}


@pytest.mark.cuda
def test_f64_launches_count_with_the_tracer_off_or_on(band64):
    """On the card an f64 call on the stripe route is one ``staged_f64``
    launch, counted whether the tracer is on or not; ``quad`` and
    ``staged`` and the semiring counter do not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    op = operator(relabeled_band().astype(np.float64), dev)
    x = torch.randn(op.n, dtype=torch.float64, device=dev)
    op.mul(x)
    op.tr_mul(x)
    for on in (False, True):
        if on:
            trace.enable()
        before, semi = trace.launches_by_map(), trace.semiring_calls()
        op.mul(x)
        op.tr_mul(x, 2.0, 0.5, x)
        assert trace.launches_by_map() == {**before, "staged_f64": before["staged_f64"] + 2}
        assert trace.semiring_calls() == semi
        trace.disable()
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
def test_launch_spans_and_counter_on_the_card(band):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    op = operator(band, dev)
    x, X = operands(op.n, dev)
    for _, _, call in CALLS[:4]:  # each call's routed format built
        call(op, x, X)
    torch.cuda.synchronize(dev)
    for name, root, call in CALLS[:4]:
        trace.reset()
        trace.enable()
        before = trace.launches()
        call(op, x, X)
        assert trace.launches() == before + 1
        trace.disable()
        spans = trace.snapshot()["spans"]
        assert [s["name"] for s in spans] == [root, "op.check", "op.alloc", "op.launch"]
        assert all(s["call"] == 0 for s in spans)
    torch.cuda.synchronize(dev)
