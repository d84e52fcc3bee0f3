"""The launch probe (``vbcs_tpu_torch/probes/probe_launch.py``) against
``bench_tools/probe_launch.py``.

With ``jax.experimental.pallas.pallas_call`` patched to interpret mode
(and captured) and ``vbcs_tpu.utils.timing.periter`` patched to record
its ``make_chained`` (through ``monkeypatch``), the TPU probe's ``main()``
times nothing.  The captured Pallas kernel (``x + 1`` on ``[8, 128]``) is
held against the port's ``add_one`` (its plain version on the CPU)
bitwise, and each of the four recorded chains (one launch a step, two,
the elementwise step, the pad-and-unpad step) at a few steps against the
port's ``chained`` on the same input, to 1e-6 relative (f32 rounding of
``x * 0.999 + 1``, which XLA may fuse).  The CUDA kernel is held against
its plain version on the card in ``test_torch_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import vbcs_tpu.utils.timing as jtiming  # noqa: E402
from bench_tools import probe_launch as jpl  # noqa: E402
from vbcs_tpu_torch.probes import probe_launch as tpl  # noqa: E402

STEPS = 3


@pytest.fixture
def captured(monkeypatch):
    """The TPU probe's interpret-mode pallas call and its four chains, in
    the order the probe times them."""
    calls, chains = [], []
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        calls.append(orig(*a, **k))
        return calls[-1]

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jtiming, "periter",
                        lambda mk, *a, **k: chains.append(mk) or 1.0)
    jpl.main()
    return calls, chains


def test_kernel_matches_pallas(captured):
    calls, _ = captured
    assert len(calls) == 1
    x = np.random.default_rng(0).standard_normal(tpl.SHAPE).astype(np.float32)
    want = np.asarray(calls[0](jnp.asarray(x)))
    got = tpl.add_one(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpl.add_one_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("k", range(4))
def test_chain_matches_jax(k, captured):
    _, chains = captured
    kind = list(tpl.STEPS)[k]
    want = float(np.asarray(chains[k](STEPS)()))
    x0, xb = tpl.inputs()
    got = tpl.chained(kind, xb if kind == "pad" else x0, STEPS)
    assert got.shape == ((tpl.PAD_N,) if kind == "pad" else tpl.SHAPE)
    assert got.dtype == torch.float32
    assert abs(float(got.reshape(-1)[0]) - want) <= 1e-6 * abs(want)


def test_steps_and_refusals():
    x0, _ = tpl.inputs()
    assert torch.equal(tpl.step("two", x0), (x0 + 2.0) * 0.999)
    with pytest.raises(ValueError, match="unknown"):
        tpl.step("three", x0)
    with pytest.raises(ValueError):
        tpl.add_one(x0.double())
    with pytest.raises(ValueError):
        tpl.add_one(x0.t())
