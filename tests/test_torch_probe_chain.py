"""The chain probe (``vbcs_tpu_torch/probes/probe_chain.py``) against the
Pallas kernel of ``bench_tools/probe_chain.py``.

A recorder in place of the TPU probe's ``run_variant`` captures the four
variants of ``main()``; each then runs through the probe's own
``run_variant`` at ``T = 2`` chunks (``X = 2 * NS`` slot lanes) with
``pallas_call`` in interpret mode and a ``periter`` that only builds the
grid-``(n_iters, T)`` calls for the chain lengths under test.  The port's
chain wrapper runs its plain version on the same inputs; the persistent
CUDA kernel is held against that on the card in ``test_torch_cuda.py``.

Tolerance: ``|Δ| / max|ref| <= 2e-5`` (f32 sums in another order,
carried through the chain; values grow by ~2.8 an iteration, so the
chains are short).  The kernel runs with 64-bit types off, as on the TPU:
its ``lax.rem(program_id, 2)`` needs the literal to be int32.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_tools import probe_chain as jpc  # noqa: E402
from vbcs_tpu_torch.probes import probe_chain as tpc  # noqa: E402

T = 2
TOL = 2e-5
ITERS = (1, 3)  # one iteration, and both slots in turn


def recorded():
    rec = []
    orig = jpc.run_variant
    jpc.run_variant = lambda name, body, **k: rec.append((name, body, k))
    try:
        jpc.main()
    finally:
        jpc.run_variant = orig
    return rec


@pytest.fixture(scope="module")
def bodies():
    return {name: (body, k) for name, body, k in recorded()}


def test_every_tpu_variant_has_a_port():
    rec = recorded()
    assert [r[0] for r in rec] == [v[0] for v in tpc.VARIANTS]
    assert [r[2].get("wblk", 2) for r in rec] == [v[2] for v in tpc.VARIANTS]


@pytest.mark.parametrize("name, variant, wblk", tpc.VARIANTS)
def test_variant_matches_pallas(name, variant, wblk, bodies, monkeypatch):
    body, k = bodies[name]
    monkeypatch.setattr(jpc, "T", T)
    monkeypatch.setattr(jpc, "X", T * jpc.NS)
    calls = []
    orig = pl.pallas_call

    def patched(*a, **kk):
        kk["interpret"] = True
        kk.pop("compiler_params", None)
        calls.append(orig(*a, **kk))
        return calls[-1]

    def periter(mk, *a, **kk):
        for n in ITERS:
            mk(n)
        return 1.0

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jpc, "periter", periter)
    inp = tpc.inputs(T, wblk)
    with jax.enable_x64(False):
        jpc.run_variant(name, body, **k)
        assert len(calls) == len(ITERS)
        args = [jnp.asarray(t.numpy())
                for t in (inp.wbase, inp.val, inp.meta, inp.xin)]
        wants = [np.asarray(call(*args)) for call in calls]
    for n, want in zip(ITERS, wants):
        got = tpc.chain(variant, inp, n).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (8, T * 1024)
        assert np.isfinite(want).all()
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL, (n, variant)


def test_carry_adds_the_last_lane_of_the_chunk_before():
    inp = tpc.inputs(3)
    b = tpc.chain_plain("B", inp, 1)
    d = tpc.chain_plain("D", inp, 1)
    lanes0 = torch.arange(3) * 1024
    assert torch.equal(d[:, 0], b[:, 0])  # chunk 0 adds nothing
    assert torch.equal(d[:, lanes0[1:]], b[:, lanes0[1:]] + b[:, lanes0[1:] - 1])
    rest = torch.ones(3 * 1024, dtype=torch.bool)
    rest[lanes0] = False
    assert torch.equal(d[:, rest], b[:, rest])


def test_refusals():
    inp = tpc.inputs(1)
    with pytest.raises(ValueError, match="unknown"):
        tpc.chain("E", inp, 1)
    with pytest.raises(ValueError, match="n_iters"):
        tpc.chain("B", inp, 0)
    with pytest.raises(ValueError, match="n_iters"):
        tpc.chain("B", inp, 2**31)
    with pytest.raises(ValueError, match="meta"):
        tpc.chain("B", inp._replace(meta=inp.meta.long()), 1)
    with pytest.raises(ValueError, match="wbase"):
        tpc.chain("B", inp._replace(wbase=inp.wbase[:3]), 1)


@pytest.mark.parametrize("variant, wblk", [("B", 2), ("C", 1)])
def test_library_matrix_is_one_iteration(variant, wblk):
    """``library_matrix``, the matrix ``chip_smoke.py`` times
    ``torch.addmv`` on beside the chain kernel's marginal iteration,
    applies one iteration of the full body to x (f32 sums in another
    order: TOL); ``A`` and ``D`` are no such product."""
    inp = tpc.inputs(3, wblk)
    M = tpc.library_matrix(variant, inp)
    assert M.shape == (8 * 3 * 1024, 8 * 3 * 1024)
    z = torch.zeros(M.shape[0])
    got = torch.addmv(z, M, inp.xin.reshape(-1), beta=0.0, alpha=0.999)
    want = tpc.chain_plain(variant, inp, 1).reshape(-1)
    assert (got - want).abs().max() <= TOL * want.abs().max()
    for other in ("A", "D"):
        with pytest.raises(ValueError):
            tpc.library_matrix(other, inp)
