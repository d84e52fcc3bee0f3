"""The SpMM load-path probe (``vbcs_tpu_torch/probes/probe_spmm4.py``)
against ``bench_tools/probe_spmm4.py``.

The TPU probe builds its Pallas call inside ``main()``; with
``jax.experimental.pallas.pallas_call`` and ``vbcs_tpu.utils.timing.periter``
patched (through ``monkeypatch``) ``main()`` times nothing and the call's
kernel and specs are captured.  The call is rebuilt over ``T = 2`` chunks
in interpret mode and run on the port's inputs for ``T = 2``; the port's
FMA wrapper runs its plain version on the same CPU tensors (the CUDA
kernel is held against that on the card in ``test_torch_cuda.py``).
Part (a), the XLA row gather, is no Pallas kernel: ``row_gather`` is
held against ``jnp.take`` bitwise.

Tolerance: ``|Δ| / max|ref| <= 2e-5`` for the FMA (f32 sums in another
order).
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
import vbcs_tpu.utils.timing as jtiming  # noqa: E402
from bench_tools import probe_spmm4 as jps  # noqa: E402
from vbcs_tpu_torch.probes import probe_spmm4 as tps  # noqa: E402

T = 2
TOL = 2e-5


@pytest.fixture(scope="module")
def captured():
    """The TPU probe's pallas_call (args, kwargs) and its timed chains."""
    mp = pytest.MonkeyPatch()
    calls, chains = [], []
    mp.setattr(pl, "pallas_call", lambda *a, **k: calls.append((a, k)))
    mp.setattr(jtiming, "periter", lambda mk, *a, **k: chains.append(mk) or 1.0)
    try:
        jps.main()
    finally:
        mp.undo()
    return calls, chains


def test_probe_has_one_kernel_and_two_timed_parts(captured):
    calls, chains = captured
    assert len(calls) == 1 and len(chains) == 2
    _, k = calls[0]
    assert k["grid"] == (tps.T,)
    assert k["out_shape"].shape == (tps.T * tps.RC, 128)


def test_fma_matches_pallas(captured):
    a, k = captured[0][0]
    k = {key: v for key, v in k.items() if key != "compiler_params"}
    k.update(grid=(T,), interpret=True,
             out_shape=jax.ShapeDtypeStruct((T * tps.RC, 128), jnp.float32))
    call = pl.pallas_call(*a, **k)
    inp = tps.inputs(T, m=1000)
    want = np.asarray(call(jnp.asarray(inp.Xg.numpy()), jnp.asarray(inp.Vl.numpy())))
    got = tps.fma(inp.Xg, inp.Vl).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (T * 2048, 128)
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL
    lib = tps.fma_library(inp.Xg, inp.Vl).numpy()
    assert np.abs(lib - want).max() / np.abs(want).max() <= TOL


def test_fma_row_map():
    """out[t*2048 + 8p + w] = sum_j Vl[t*2048 + 256j + p, w] * Xg[same row]."""
    inp = tps.inputs(2, m=10)
    out = tps.fma(inp.Xg, inp.Vl)
    for t, p, w in ((0, 0, 0), (1, 255, 7), (1, 17, 3)):
        rows = t * 2048 + 256 * torch.arange(8) + p
        want = (inp.Vl[rows, w, None].double() * inp.Xg[rows].double()).sum(0)
        assert torch.allclose(out[t * 2048 + 8 * p + w].double(), want, atol=1e-5)


def test_row_gather_matches_take():
    inp = tps.inputs(1, m=5000)
    rows = inp.rows % 5000  # rows of the smaller X
    want = np.asarray(jnp.take(jnp.asarray(inp.X.numpy()),
                               jnp.asarray(rows.numpy()), axis=0))
    np.testing.assert_array_equal(tps.row_gather(inp.X, rows).numpy(), want)


def test_refusals():
    inp = tps.inputs(1, m=10)
    with pytest.raises(ValueError, match="Xg"):
        tps.fma(inp.Xg[:100], inp.Vl[:100])
    with pytest.raises(ValueError, match="Vl"):
        tps.fma(inp.Xg, inp.Vl[:, :4].contiguous())
