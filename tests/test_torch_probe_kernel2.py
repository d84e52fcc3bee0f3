"""The chunk probe (``vbcs_tpu_torch/probes/probe_kernel2.py``) against the
Pallas bodies of ``bench_tools/probe_kernel2.py``.

As in ``test_torch_probe_kernel.py``: a recorder in place of the TPU
probe's ``run_variant`` captures every variant of ``main()``, each runs
through the probe's own ``run_variant`` at ``T = 2`` chunks with
``pallas_call`` in interpret mode, and the port's chunk wrapper runs its
plain version on the same inputs (int32 or int16 metadata, one or two
windows a slice, an x of 2,504 or 8,192 rows, as the variant asks).

Tolerances: gathers and copies bitwise; sums ``|Δ| / max|ref| <= 2e-5``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_tools import probe_kernel2 as jpk2  # noqa: E402
from vbcs_tpu_torch.probes import chunk as ck  # noqa: E402
from vbcs_tpu_torch.probes import probe_kernel2 as tpk2  # noqa: E402

T = 2
TOL = 2e-5


def recorded():
    """[(name, body, kwargs)] of every run_variant call of main()."""
    rec = []
    orig = jpk2.run_variant
    jpk2.run_variant = lambda name, body, **k: rec.append((name, body, k))
    try:
        jpk2.main()
    finally:
        jpk2.run_variant = orig
    return rec


@pytest.fixture(scope="module")
def bodies():
    return {name: (body, k) for name, body, k in recorded()}


def test_every_tpu_variant_has_a_port():
    rec = recorded()
    assert [r[0] for r in rec] == [v[0] for v in tpk2.VARIANTS]
    for (_, _, k), (_, _, kw) in zip(rec, tpk2.VARIANTS):
        assert set(k) == set(kw)
        assert all(np.dtype(k[key]) == np.dtype(kw[key]) if key == "meta_dtype"
                   else k[key] == kw[key] for key in k)


@pytest.mark.parametrize("name, variant, kw", tpk2.VARIANTS)
def test_variant_matches_pallas(name, variant, kw, bodies, monkeypatch):
    body, k = bodies[name]
    monkeypatch.setattr(jpk2, "T", T)
    monkeypatch.setattr(jpk2, "periter", lambda *a, **kk: 1.0)
    calls = []
    orig = pl.pallas_call

    def patched(*a, **kk):
        kk["interpret"] = True
        kk.pop("compiler_params", None)
        calls.append(orig(*a, **kk))
        return calls[-1]

    monkeypatch.setattr(pl, "pallas_call", patched)
    jpk2.run_variant(name, body, **k)
    inp = tpk2.inputs(T, **kw)
    want = np.asarray(calls[-1](*(jnp.asarray(t.numpy()) for t in (
        inp.tab, inp.val, inp.m0, inp.m1, inp.x))))
    got = ck.chunk(variant, inp).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (8, T * 1024)
    if variant in ck.BITWISE:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL
    np.testing.assert_array_equal(got, ck.chunk_plain(variant, inp).numpy())


def test_gather_reads_the_second_table_at_the_gathered_lane():
    """take2: ``A`` comes from hiA at the lane ``lo`` the gather reads,
    not at the output's own lane (a table that differs only there)."""
    inp = tpk2.inputs(1)
    lo = inp.m0.clone()
    lo[:, 0] = 5  # output lane 0 of slice 0 gathers lane 5
    hi = inp.m1.clone()
    hi[:, 0], hi[:, 5] = 0, 7  # A at lane 0: 0, at lane 5: 7
    got = ck.chunk("take2", inp._replace(m0=lo, m1=hi))
    b = int(inp.tab[0])
    assert np.array_equal(got[:, 0].numpy(), inp.x[b + 7, 5].expand(8).numpy())


def test_bounds_count_what_the_function_needs():
    """The full-size byte counts the bounds rest on (T = 39)."""
    d = ck.needed_bytes("take2_red", tpk2.inputs())
    d16 = ck.needed_bytes("take2_red", tpk2.inputs(meta_dtype=np.int16))
    f = ck.needed_bytes("take2_red", tpk2.inputs(xrows=8192))
    assert (round(d / 1e6, 2), round(d16 / 1e6, 2), round(f / 1e6, 2)) == (
        15.34, 14.06, 18.25)
    a = tpk2.inputs()
    assert ck.streamed_bytes("stream", a) == d - a.x.numel() * 4 - a.tab.numel() * 4


@pytest.mark.parametrize("probe, variant", [("kernel2", "take2_red"), ("kernel", "ladder_red"),
                                            ("kernel", "sub3_red"), ("kernel", "const_red")])
def test_library_matrix_applies_the_variant(probe, variant):
    """``chunk.library_matrix``, the matrix ``chip_smoke.py`` times
    ``torch.addmv`` on beside the chunk kernel, applies the ``*_red``
    variant to x (f32 sums in another order: 2e-5)."""
    from vbcs_tpu_torch.probes import probe_kernel as tpk
    inp = (tpk2.inputs(T) if probe == "kernel2" else tpk.inputs(T))
    M = ck.library_matrix(variant, inp)
    got = (M @ inp.x.reshape(-1)).view(8, -1).numpy()
    want = ck.chunk_plain(variant, inp).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        ck.library_matrix("take2", inp)
