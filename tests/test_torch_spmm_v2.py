"""The port's SpMM against the JAX v2 SpMM on a multi-class plan.

``tr_spmm_pallas`` (``vbcs_tpu/ops/pallas_spmm.py``, the operator's
general route and every ``mul_mat``) runs one Pallas pass per class and
per 4 RHS columns, each a slow interpret-mode call, so these cases have
a file of their own and a plan of two narrow classes.  k=5 and k=9 pad
the last 4-column pass.  Tolerance as in ``test_torch_spmm.py``.
"""

import jax.numpy as jnp
import pytest

import vbcs_tpu as v
from test_torch_spmm import banded, check_port, interpret_mode, jax_routes, rhs  # noqa: F401
from vbcs_tpu.ops import pallas_spmm as pm
from vbcs_tpu.ops import pallas_trspmv2 as pk2


@pytest.mark.parametrize("k", [5, 9])
def test_matches_spmm_v2_multiclass(k, jax_routes):
    A = banded(128, 128, 3, 30, seed=4)
    B = v.vbc1d(A, 2, v.DynamicTotalChunker(v.model_1dvbc_memory(2, 4), 2))
    fmt2 = pk2.pack_stream2(B)
    assert len(fmt2.classes) == 2 and fmt2.fallback is None
    X = rhs(A.shape[0], k)
    check_port(B, A, X, pm.tr_spmm_pallas(fmt2, jnp.asarray(X)))
    assert jax_routes == ["tr_spmm_pallas"]
