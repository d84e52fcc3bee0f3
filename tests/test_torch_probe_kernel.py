"""The chunk probe (``vbcs_tpu_torch/probes/probe_kernel.py``) against the
Pallas bodies of ``bench_tools/probe_kernel.py``.

``main()`` of the TPU probe looks up ``run_variant`` as a module global,
so a recorder in its place captures every ``(name, body, ...)`` without
editing the probe.  Each captured variant then runs through the probe's
own ``run_variant`` at ``T = 2`` chunks with ``pallas_call`` in
interpret mode (its ``call`` captured, ``periter`` a no-op), on the
port's inputs for ``T = 2``; the port's chunk wrapper runs its plain
version on the same CPU tensors.  The CUDA kernel is held against that
plain version on the card in ``test_torch_cuda.py``.

Tolerances: gathers and copies bitwise; sums ``|Δ| / max|ref| <= 2e-5``
(f32, another summation order).  This JAX refuses the negative shift of
variant 2c's ``pltpu.roll(wv, -1, 0)``; the test gives it the equal
positive shift (+7 of 8 rows, as ``probe_kernel2``'s variant e writes it).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_tools import probe_kernel as jpk  # noqa: E402
from vbcs_tpu_torch.probes import chunk as ck  # noqa: E402
from vbcs_tpu_torch.probes import probe_kernel as tpk  # noqa: E402

T = 2
TOL = 2e-5


@pytest.fixture(scope="module")
def bodies():
    """name -> (body, args, kwargs) of every run_variant call of main()."""
    rec = {}
    orig = jpk.run_variant
    jpk.run_variant = lambda name, body, *a, **k: rec.setdefault(name, (body, a, k))
    try:
        jpk.main()
    finally:
        jpk.run_variant = orig
    return rec


def capture_calls(monkeypatch, module):
    """Patch ``pallas_call`` to interpret mode and collect what it returns;
    ``periter`` of ``module`` times nothing."""
    calls = []
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        calls.append(orig(*a, **k))
        return calls[-1]

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(module, "periter", lambda *a, **k: 1.0)
    return calls


def assert_match(variant, got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if variant in ck.BITWISE:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def test_every_tpu_variant_has_a_port():
    names = []
    orig = jpk.run_variant
    jpk.run_variant = lambda name, *a, **k: names.append(name)
    try:
        jpk.main()
    finally:
        jpk.run_variant = orig
    assert names == [v[0] for v in tpk.VARIANTS]
    assert all(kw == {} for _, _, kw in tpk.VARIANTS)  # one set of inputs


@pytest.mark.parametrize("name, variant, kw", tpk.VARIANTS)
def test_variant_matches_pallas(name, variant, kw, bodies, monkeypatch):
    body, a, k = bodies[name]
    monkeypatch.setattr(jpk, "T", T)
    calls = capture_calls(monkeypatch, jpk)
    roll = pltpu.roll
    monkeypatch.setattr(pltpu, "roll", lambda x, shift, axis, **kws: roll(
        x, shift % x.shape[axis], axis, **kws))
    jpk.run_variant(name, body, *a, **k)
    inp = tpk.inputs(T)
    val, row, x2d, xtile = (jnp.asarray(t.numpy()) for t in
                            (inp.val, inp.m0, inp.x, inp.tab))
    want = np.asarray(calls[-1](xtile, val, row, *[x2d] * (8 * 3),
                                *k.get("extra_inputs", ())))
    got = ck.chunk(variant, inp).numpy()
    assert got.shape == (8, T * 1024)
    assert_match(variant, got, want)
    np.testing.assert_array_equal(got, ck.chunk_plain(variant, inp).numpy())


def test_bounds_count_what_the_function_needs():
    """The full-size byte counts the bounds rest on (T = 39)."""
    inp = tpk.inputs()
    assert inp.val.shape == (64, 39 * 1024) and inp.x.shape == (376, 128)
    assert ck.needed_bytes("ladder_red", inp) == 12_975_776  # 3.87 us
    assert ck.needed_bytes("stream", inp) == 3_833_856  # val rows 0-15, out
    assert ck.streamed_bytes("stream", inp) == 64 * 39936 * 4 + 2 * 8 * 39936 * 4
    assert ck.needed_bytes("sub3_red", inp) == ck.needed_bytes("ladder_red", inp)
    assert ck.needed_bytes("const_red", inp) == (64 + 8) * 39936 * 4 + 376 * 512 + 936 * 4


def test_refusals():
    inp = tpk.inputs(1)
    with pytest.raises(ValueError, match="unknown"):
        ck.chunk("nope", inp)
    with pytest.raises(ValueError, match="val"):
        ck.chunk("stream", inp._replace(val=inp.val[:, :1000]))
    with pytest.raises(ValueError, match="m0"):
        ck.chunk("ladder", inp._replace(m0=inp.m0.long()))
    with pytest.raises(ValueError, match="x must"):
        ck.chunk("ladder", inp._replace(x=inp.x.double()))
    with pytest.raises(ValueError, match="tab"):
        ck.chunk("ladder", inp._replace(tab=inp.tab[:5]))
    with pytest.raises(ValueError, match="needs m1"):
        ck.chunk("take2", inp)
    assert ck.chunk("stream", inp).shape == (8, 1024)
