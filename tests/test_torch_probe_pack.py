"""``vbcs_tpu_torch.probes.probe_pack`` (the port of
``bench_tools/probe_pack.py``) on the CPU, where the device stages run the
plain versions: every stage timed, the device DP's plan held to the host
DP's, ``--profile`` and the command line.  Its times mean something only
on the card (``chip_smoke.py`` phase 17)."""

import json

import numpy as np
import pytest
import torch

from vbcs_tpu_torch.formats.partition import SplitPartition
from vbcs_tpu_torch.probes import probe_pack
from vbcs_tpu_torch.tools.matrices import blocky_matrix, fem_matrix

PLAN_STAGES = ["gen", "plan host DP", "plan device DP", "vbc1d pack",
               "VBC1DDevice", "ScatterDevice"]


@pytest.fixture
def small(monkeypatch):
    """The probe's generators at small sizes."""
    monkeypatch.setattr(probe_pack, "blocky_matrix", lambda: blocky_matrix(L=400))
    monkeypatch.setattr(probe_pack, "fem_matrix", lambda: fem_matrix(k=24))


def test_every_stage_is_timed(small):
    out = probe_pack.run("all", "cpu")
    assert list(out["flagship"]) == PLAN_STAGES
    assert list(out["fem"]) == PLAN_STAGES[:1] + ["from_csc (auto-RCM)"] + PLAN_STAGES[1:]
    assert all(t >= 0 for times in out.values() for t in times.values())
    assert list(probe_pack.run("fem", "cpu")) == ["fem"]


def test_a_device_plan_unlike_the_host_one_fails(small, monkeypatch):
    monkeypatch.setattr(probe_pack, "dp_partition_device",
                        lambda C, model, W, device: SplitPartition.equi(C.n, 1))
    with pytest.raises(RuntimeError, match="differs from the host DP"):
        probe_pack.run("flagship", "cpu")


def test_profile_prints_the_pack_calls(small, capsys):
    out = probe_pack.run("flagship", "cpu", profile=True)
    text = capsys.readouterr().out
    assert "Ordered by: cumulative time" in text and "pack_1dvbc" in text
    assert "vbc1d pack" not in out["flagship"]


def test_command_line_on_the_cpu(capsys):
    out = probe_pack.main(["fem", "--device", "cpu"])
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("PACK ")]
    assert json.loads(line[0][len("PACK "):]) == out
    assert out["fem"]["plan device DP"] > 0
    with pytest.raises(SystemExit):
        probe_pack.main(["none"])
    with pytest.raises(ValueError):
        probe_pack.run("none", "cpu")


def test_command_line_without_a_card_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="needs a card"):
        probe_pack.main(["flagship"])
