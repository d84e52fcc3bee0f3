"""``vbcs_tpu_torch/utils/profile.py``: the bytes a TrSpMV over each
device format moves, the roofline from the card's data-sheet peaks (a CPU
device or an unknown card raises).  The card's name is patched in; no
number here is a device measurement."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.utils import profile


def formats():
    A = sp.random(300, 200, 0.05, random_state=3, format="csc", dtype=np.float32)
    B = vt.vbc1d(A, 8)
    return [vt.VBC1DDevice.from_host(B, "cpu"), vt.ScatterDevice.from_host(B, "cpu"),
            vt.VBC2DDevice.from_host(vt.vbc2d(A, 4, 4), "cpu")]


@pytest.mark.parametrize("k", range(3))
def test_stream_bytes_counts_arrays_x_and_y(k):
    fmt = formats()[k]
    arrays = [f for f in vars(fmt).values() if isinstance(f, torch.Tensor)]
    assert profile.stream_bytes(fmt) == fmt.nbytes + 4 * (300 + 200)
    assert fmt.nbytes == sum(t.numel() * t.element_size() for t in arrays)


def test_stream_bytes_refuses_other_objects():
    with pytest.raises(TypeError):
        profile.stream_bytes(np.zeros(3))


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")


def test_roofline_from_the_card_name(h100):
    assert profile.hbm_bandwidth("cuda") == 3.35e12
    assert profile.f32_flops("cuda:0") == 67e12
    r = profile.roofline(3_350_000, 2e-6, "cuda")
    assert r.bound_by == "bytes" and r.ideal_s == pytest.approx(1e-6)
    assert r.fraction == pytest.approx(0.5)
    r = profile.roofline(8, None, "cuda", flops=67_000_000)
    assert r.bound_by == "operations" and r.ideal_s == pytest.approx(1e-6)
    assert r.fraction is None and "operations" in str(r)
    fmt = formats()[0]
    r = profile.roofline(fmt, 1e-5, "cuda")
    assert r.bytes_moved == profile.stream_bytes(fmt)
    assert r.flops == 2 * fmt.val.numel() and "% of roofline" in str(r)


def test_roofline_refuses_cpu_and_unknown_cards(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        profile.roofline(100, 1.0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        profile.hbm_bandwidth(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "GPU X")
    with pytest.raises(ValueError, match="GPU X"):
        profile.roofline(100, 1.0, "cuda")

