"""The port's tracer in a cell's run (``spbench/spans.py``): a run of
the harness as ``spbench.run`` makes it records no span and calls no profiler
function; a run with the tracer on reports the planner's parts; the
readings on made-up spans; and a device trace's idle gap named by the
port's span around it."""

import time

import pytest
from vbcs_tpu_torch.utils import trace

from spbench import harness, spans
from spbench import trace as capture
from spbench.tests.small import CELLS, small_cell

SECONDS = 0.3
SEED = 2**31 + 91


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_the_harness_run_records_no_span(name, traced, monkeypatch):
    asked = []
    monkeypatch.setattr(trace, "_profiling", lambda: asked.append(1))
    result, _ = harness.run_cell(small_cell(name, traced), SEED, SECONDS, traced, "cpu",
                                 time.perf_counter(), log=lambda *a: None)
    assert result["correct"]
    assert trace.snapshot() == {"spans": [], "counters": {}} and not asked


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_planner(name):
    tracing = spans.Tracing()
    result, run = harness.run_cell(small_cell(name), SEED, SECONDS, False, "cpu",
                                   time.perf_counter(), tracing.operator,
                                   log=lambda *a: None)
    assert result["correct"]
    out = tracing.finish(run)
    assert not trace.enabled() and trace.snapshot()["spans"] == []
    assert out["window_calls"] == run.window.calls > 0
    assert out["calls"] > out["window_calls"]  # the warm-up's calls
    assert out["setup"]["from_csc"]["count"] == 1
    got = out["readings"]
    planner = [got[k] for k in spans.PLANNER]
    assert all(v is not None and v > 0 for v in planner)
    assert sum(planner) <= run.phases["from_csc_s"]
    # the CPU's plain versions launch nothing
    assert got["launches_per_call"] == 0
    assert got["operator_host_us"] is None and got["launch_host_us"] is None


def made_up():
    """from_csc's tree, a route built outside a call, two warm-up calls
    and three window calls of 10 us, each with a 4 us launch."""
    out = []

    def add(name, t0, t1, parent=-1):
        call = out[parent]["call"] if parent >= 0 else 1 + max(
            [s["call"] for s in out], default=-1)
        out.append({"name": name, "start_ns": t0, "end_ns": t1, "parent": parent,
                    "call": call})
        return len(out) - 1

    root = add("from_csc", 0, 10_000)
    for name, t0, t1 in [("plan.dp", 0, 1000), ("plan.pack", 1000, 3000),
                         ("plan.badness", 3000, 3500), ("plan.rcm", 3500, 5500),
                         ("plan.transpose", 5500, 6000), ("plan.upload", 6000, 9000)]:
        add(name, t0, t1, root)
    add("op.route", 11_000, 12_000)
    for k in range(5):
        t = 20_000 + 100_000 * k
        r = add("op.mul", t, t + 10_000)
        add("op.check", t + 1000, t + 2000, r)
        add("op.launch", t + 5000, t + 9000, r)
    return out


def test_readings_on_made_up_spans():
    out = spans.split(made_up(), 3)
    assert out["window_calls"] == 3 and out["calls"] == 5
    assert out["setup"]["op.mul"]["count"] == 2 and out["window"]["op.mul"]["count"] == 3
    assert "from_csc" not in out["window"] and "op.route" in out["setup"]
    out["launches"] = 5
    got = spans.readings(out)
    want = {"reorder_s": 2.5e-6, "dp_s": 1e-6, "pack_s": 2.5e-6, "upload_s": 3e-6,
            "operator_host_us": 6.0, "launch_host_us": 4.0, "launches_per_call": 1.0}
    assert got == pytest.approx(want)
    none = spans.readings({**spans.split([], 0), "launches": 0})
    assert all(v is None for v in none.values())


def test_an_idle_gap_is_named_by_the_port_span_around_it():
    trace.enable()
    cap = capture.Capture()
    cap.start()
    with trace.span("op.mul"):
        time.sleep(0.005)
    cap.stop(1)
    gaps = dict(cap.summary()["idle_gaps"])
    # no device work on the CPU: the window is one gap, mostly the span's
    assert gaps["op.mul"] >= 0.0045
