"""``BENCHMARK.json`` parses, keeps to the contract's shapes, and every
name in it is a file the harness finds."""

import json
import math
import os
import re

from spbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def manifest():
    return harness.load_manifest()


def test_shape_and_characters():
    man = manifest()
    assert set(man) == KEYS
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(man["command"]) <= 32
    assert all(LINE.match(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    assert len({w["name"] for w in man["workloads"]}) == len(man["workloads"])
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(man["workloads"]) // 4)
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_is_a_file():
    man = manifest()
    cells = {w["name"] for w in man["workloads"]}
    for c in man["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert os.path.join(os.path.dirname(harness.ROOT), c["file"]) == os.path.join(
            harness.ROOT, "configs", c["name"] + ".json")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert harness.load_module("gen", cfg["generator"]).generate
        assert any(w["config"] == c["name"] for w in man["workloads"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for w in man["workloads"]:
        for trace in (False, True):
            cell = harness.cell_of(man, w["name"], trace)
            assert cell.metrics
        limit = harness.load_json("limits", w["name"])["rel_err"]
        assert 0 < limit < 1 and math.isfinite(limit)
        e2e = [m["name"] for m in harness.cell_of(man, w["name"], False).metrics]
        assert "setup_s" in e2e and len(e2e) >= 2
        # each per-layer metric's end-to-end metric is one its cells report
        for m in harness.cell_of(man, w["name"], True).metrics:
            assert m["moves"] in e2e


def test_traffic_files_are_data():
    man = manifest()
    for w in man["workloads"]:
        with open(os.path.join(harness.ROOT, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        assert isinstance(t["sync_every"], int) and t["sync_every"] >= 1
        assert t["operands"] >= 1 and t["samples"] >= 1
