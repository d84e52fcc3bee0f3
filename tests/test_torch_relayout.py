"""The port's tile relayout (``ops/relayout.py``) against the JAX one.

``tile_relayout(x, R)`` maps natural ``x[:m]``, zero-padded to ``R*1024``,
to the ``(8, R*128)`` tile-interleaved buffer.  The JAX package has it
twice: the Pallas kernel ``pallas_trspmv3._tile_relayout_call(Rb)``
(interpret mode; ``Rb`` blocks of 8,192 elements, so ``R = 8*Rb``) and
the XLA formula ``entry3`` builds for its ``"tile"`` entry mode.  A
relayout moves values without arithmetic: bitwise equal to both.  On the
CPU the port's wrapper runs its plain version; the CUDA kernel is held
against it on the card in ``test_torch_cuda.py``.
"""

import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu.ops import pallas_trspmv3 as pk3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(pk3.pl, "pallas_call", patched)
    yield


@pytest.mark.parametrize("Rb", [1, 3])
def test_matches_pallas_kernel(Rb):
    R = 8 * Rb
    m = R * 1024 - 77  # the kernel takes x zero-padded to whole blocks
    x = np.random.default_rng(Rb).standard_normal(m).astype(np.float32)
    xin = np.zeros(R * 1024, np.float32)
    xin[:m] = x
    want = np.asarray(pk3._tile_relayout_call(Rb)(
        jnp.asarray(xin.reshape(Rb * 64, 128))))
    got = vt.tile_relayout(torch.from_numpy(x), R).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (8, R * 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R, m", [(1, 1000), (3, 2100), (313, 320_000)])
def test_matches_entry3_tile_mode(R, m):
    x = np.random.default_rng(R).standard_normal(m).astype(np.float32)
    fmt = types.SimpleNamespace(entry_mode="tile", X=R * 128, m=m)
    want = np.asarray(pk3.entry3(fmt, jnp.asarray(x)))
    got = vt.tile_relayout(torch.from_numpy(x), R).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        vt.tile_relayout_plain(torch.from_numpy(x), R).numpy(), want)


def test_element_map_and_refusals():
    R = 2
    x = torch.arange(R * 1024 - 5, dtype=torch.float32)
    out = vt.tile_relayout(x, R)
    for s, k, l in ((0, 0, 0), (7, 1, 127), (3, 1, 5), (7, 1, 123)):
        src = k * 1024 + s * 128 + l
        assert out[s, k * 128 + l] == (src if src < x.numel() else 0)
    with pytest.raises(ValueError):
        vt.tile_relayout(torch.zeros(1025), 1)  # m > R*1024
    with pytest.raises(ValueError):
        vt.tile_relayout(torch.zeros(4), 0)
    with pytest.raises(TypeError):
        vt.tile_relayout(torch.zeros(4, dtype=torch.float64), 1)
    with pytest.raises(ValueError):
        vt.tile_relayout(torch.zeros(8, 2)[:, 0], 1)  # not contiguous
