"""The split-point DP on a torch device (``vbcs_tpu_torch.plan.device_dp``,
``ops/dp.py``) on the CPU, where its two kernels run their plain
versions: against the JAX package's ``dp_partition_jit``/``_2d`` (jit on
the CPU) and the host DP ``plan/dynamic.dp_partition`` (the C++ DP), split
points bitwise; the stripe-cost table against a NumPy walk of the host's
counters, bitwise.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu.formats.csc import CSC as JCSC
from vbcs_tpu.formats.partition import SplitPartition as JSplit
from vbcs_tpu.models import cost as jcost
from vbcs_tpu.plan import jax_dp
from vbcs_tpu_torch.ops import dp as dp_ops
from vbcs_tpu_torch.plan import device_dp
from vbcs_tpu_torch.plan.dynamic import dp_partition

CPU = torch.device("cpu")


def csc(A):
    return vt.CSC.from_scipy(sp.csc_matrix(A))


def fitted_1d(W, seed=0):
    """A 1-D model with fractional tables, like a fitted time model."""
    rng = np.random.default_rng(seed)
    return vt.ColumnBlockComponentCostModel(
        alpha_col=np.cumsum(rng.uniform(0.1, 1.3, W)) * 0.37,
        beta_col=np.cumsum(rng.uniform(0.01, 0.2, W)) * 0.29)


def fitted_2d(W, U=4, seed=0):
    """A rank-2 2-D model with fractional tables."""
    rng = np.random.default_rng(seed)
    return vt.BlockComponentCostModel(
        alpha_row=np.cumsum(rng.uniform(0.1, 1.0, U)),
        alpha_col=np.cumsum(rng.uniform(0.1, 1.3, W)) * 0.41,
        beta_row=(np.cumsum(rng.uniform(0.1, 0.5, U)) * 0.3,
                  rng.uniform(0.05, 0.3, U)),
        beta_col=(np.cumsum(rng.uniform(0.01, 0.2, W)) * 0.7,
                  np.cumsum(rng.uniform(0.01, 0.1, W))))


def plan(A, model, W, Pi=None):
    if isinstance(model, vt.ColumnBlockComponentCostModel):
        return vt.dp_partition_device(A, model, W, device=CPU)
    return vt.dp_partition_device_2d(A, model, W, Pi, device=CPU)


def assert_host(A, model, W, Pi=None):
    got = plan(A, model, W, Pi)
    want = dp_partition(A, model, W, row_partition=Pi)
    np.testing.assert_array_equal(got.spl, want.spl)
    return got


# ---- the JAX package's cases (tests/test_jax_dp.py) ------------------------

@pytest.mark.parametrize("trial", range(4))
def test_matches_jax_dp_partition_jit(trial):
    rng = np.random.default_rng(0)
    for _ in range(trial + 1):
        m, n = int(rng.integers(20, 150)), int(rng.integers(20, 250))
    S = sp.random(m, n, 0.06, random_state=trial, format="csc")
    for model, jmodel in ((vt.model_1dvbc_memory(8, 8), jcost.model_1dvbc_memory(8, 8)),
                          (vt.ColumnBlockComponentCostModel(2.0, 1.5),
                           jcost.ColumnBlockComponentCostModel(2.0, 1.5))):
        want = jax_dp.dp_partition_jit(JCSC.from_scipy(S), jmodel, 5)
        got = assert_host(csc(S), model, 5)
        np.testing.assert_array_equal(got.spl, want.spl)


def test_2d_matches_jax_dp_partition_jit_2d():
    S = sp.random(120, 150, 0.08, random_state=21, format="csc")
    kw = dict(alpha_row=2.0, alpha_col=np.array([5.0, 6.0, 8.0, 9.0]),
              beta_row=(np.array([1.0, 1.5, 2.0]),),
              beta_col=(np.array([1.0, 1.2, 1.7, 2.5]),))
    want = jax_dp.dp_partition_jit_2d(JCSC.from_scipy(S),
                                      jcost.BlockComponentCostModel(**kw), 4,
                                      Pi=JSplit.equi(120, 3))
    got = assert_host(csc(S), vt.BlockComponentCostModel(**kw), 4,
                      vt.SplitPartition.equi(120, 3))
    np.testing.assert_array_equal(got.spl, want.spl)


# ---- the host DP on fractional tables, where the order of the sums matters --

@pytest.mark.parametrize("W", [1, 5, 8, 16, 33])
def test_fractional_tables_match_the_host_dp(W):
    for seed in range(3):
        S = sp.random(300, 700, 0.02, random_state=seed, format="csc")
        assert_host(csc(S), fitted_1d(W, seed), W)
        assert_host(csc(S), fitted_2d(W, seed=seed), W,
                    vt.SplitPartition.equi(300, 4))


def test_2d_repeated_blocks_of_a_column_and_default_row_partition():
    """Several rows of one block in one column (the C++ DP subtracts and
    adds them at that column); and Pi None, every row a block."""
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 64, 2000)
    cols = np.repeat(np.arange(400), 5)
    A = csc(sp.coo_matrix((np.ones(2000), (rows, cols)), shape=(64, 400)))
    for W in (3, 8):
        assert_host(A, fitted_2d(W, U=8), W, vt.SplitPartition.equi(64, 8))
        assert_host(A, vt.model_vbc_memory(4, 8), W, vt.SplitPartition.equi(64, 8))
    mdl = vt.BlockComponentCostModel(0, np.arange(1.0, 6.0), (1.0,), (np.ones(5),))
    assert_host(A, mdl, 5)


def test_blocky_matrix_and_fem():
    from vbcs_tpu_torch.tools.matrices import blocky_matrix, fem_matrix
    for A in (blocky_matrix(L=300), fem_matrix(k=24)):
        for W in (4, 8):
            assert_host(csc(A), vt.model_1dvbc_memory(4, 8), W)
            assert_host(csc(A), fitted_1d(W, 7), W)


# ---- edges ----------------------------------------------------------------------

def test_ties_take_the_narrowest_stripe():
    """Each stripe costs its width: every plan costs n, so every step takes
    the narrowest stripe."""
    A = csc(sp.random(50, 40, 0.2, random_state=3, format="csc"))
    for W in (1, 4, 8):
        mdl = vt.ColumnBlockComponentCostModel(np.arange(1.0, W + 1), 0.0)
        got = assert_host(A, mdl, W)
        np.testing.assert_array_equal(got.spl, np.arange(41))


def test_empty_columns_and_small_shapes():
    S = sp.random(40, 90, 0.05, random_state=5, format="lil")
    S[:, 10:30] = 0
    S[:, 60] = 0
    S = S.tocsc()
    S.eliminate_zeros()
    for W in (1, 3, 33, 200):
        assert_host(csc(S), vt.model_1dvbc_memory(4, 8), W)
        assert_host(csc(S), fitted_1d(W), W)
    one = csc(sp.csc_matrix(np.array([[1.0], [0.0], [2.0]])))
    for W in (1, 8):
        assert list(assert_host(one, vt.model_1dvbc_memory(4, 8), W).spl) == [0, 1]
    empty = csc(sp.csc_matrix((7, 12)))
    assert_host(empty, fitted_1d(5), 5)
    none = assert_host(csc(sp.csc_matrix((5, 0))), fitted_1d(3), 3)
    assert none == vt.SplitPartition.whole(0)


def test_rectangle():
    for shape in ((30, 400), (500, 60)):
        S = sp.random(*shape, 0.07, random_state=8, format="csc")
        for W in (2, 8, 33):
            assert_host(csc(S), fitted_1d(W, 2), W)
            assert_host(csc(S), fitted_2d(W, seed=2), W,
                        vt.SplitPartition.equi(shape[0], 4))


# ---- the table against the host's counters ----------------------------------

def host_table(pos, grp, wts, alpha, beta, W):
    """The C++ DP's counter sweep (native/vbc_native.cpp dp_partition), in
    NumPy scalars: the stripe costs it forms at every end column."""
    n = pos.size - 1
    R = beta.shape[0]
    lst = {}
    cnt = np.zeros((R, n))
    out = np.full((n, W), np.inf)
    for jp in range(1, n + 1):
        c = jp - 1
        for q in range(pos[c], pos[c + 1]):
            g = grp[q]
            old = lst.get(g, -1)
            for r in range(R):
                wgt = 1.0 if wts is None else wts[r, g]
                if old >= 0:
                    cnt[r, old] -= wgt
                cnt[r, c] += wgt
            lst[g] = c
        a = np.zeros(R)
        for w in range(1, min(W, jp) + 1):
            a += cnt[:, jp - w]
            stripe = alpha[w - 1]
            for r in range(R):
                stripe += a[r] * beta[r, w - 1]
            out[jp - 1, w - 1] = stripe
    return out


@pytest.mark.parametrize("W", [1, 5, 8, 33])
def test_table_walks_the_host_counters(W):
    S = sp.random(80, 200, 0.06, random_state=W, format="csc")
    A = csc(S)
    for model, Pi in ((fitted_1d(W), None), (fitted_2d(W), vt.SplitPartition.equi(80, 4)),
                      (vt.model_vbc_memory(4, 8), vt.SplitPartition.equi(80, 3))):
        pos, grp, wts, alpha, beta = device_dp.dp_inputs(A, model, W, Pi, device=CPU)
        got = dp_ops.dp_table(pos, grp, dp_ops.prev_occurrence(pos, grp), wts,
                              alpha, beta, W)
        want = host_table(pos.numpy(), grp.numpy(), None if wts is None else wts.numpy(),
                          alpha.numpy(), beta.numpy(), W)
        np.testing.assert_array_equal(got.numpy(), want)


def test_prev_occurrence_is_the_last_column_of_the_group():
    rng = np.random.default_rng(9)
    pos = np.concatenate([[0], np.cumsum(rng.integers(0, 6, 50))])
    grp = rng.integers(0, 12, pos[-1])
    want, last = np.full(grp.size, -1), {}
    for c in range(50):
        for q in range(pos[c], pos[c + 1]):
            want[q] = last.get(grp[q], -1)
            last[grp[q]] = c
    got = dp_ops.prev_occurrence(torch.from_numpy(pos), torch.from_numpy(grp))
    np.testing.assert_array_equal(got.numpy(), want)


def test_recurrence_plain_is_the_host_loop():
    rng = np.random.default_rng(1)
    S = rng.uniform(0.5, 2.0, (60, 6)).round(1)
    S[np.triu_indices(6, 1)] = np.inf  # no stripe reaches before column 0
    prev, opt = dp_ops.dp_recurrence(torch.from_numpy(S))
    best = np.zeros(61)
    for jp in range(1, 61):
        cand = [best[jp - w] + S[jp - 1, w - 1] for w in range(1, min(6, jp) + 1)]
        best[jp] = min(cand)
        assert prev[jp] == jp - 1 - int(np.argmin(cand))
    np.testing.assert_array_equal(opt.numpy(), best)


# ---- the surface --------------------------------------------------------------

def test_refusals():
    A = csc(sp.random(20, 30, 0.1, random_state=0, format="csc"))
    with pytest.raises(TypeError):
        vt.dp_partition_device(A, vt.model_vbc_memory(4, 8), 4, device=CPU)
    with pytest.raises(TypeError):
        vt.dp_partition_device_2d(A, vt.model_1dvbc_memory(4, 8), 4, device=CPU)
    with pytest.raises(TypeError):
        vt.dp_partition_device(A, vt.AffineConnectivityModel(1, 1, 1, 1), 4,
                               device=CPU)
    with pytest.raises(TypeError):
        vt.dp_partition_device(A, vt.ConstrainedCost(
            vt.model_1dvbc_memory(4, 8), vt.VertexCount(), 4), 4, device=CPU)
    for W in (0, -1):
        with pytest.raises(ValueError):
            vt.dp_partition_device(A, vt.model_1dvbc_memory(4, 8), W, device=CPU)
        with pytest.raises(ValueError):
            device_dp.dp_prev(*device_dp.dp_inputs(
                A, vt.model_1dvbc_memory(4, 8), 2, device=CPU), W)
    with pytest.raises(ValueError):
        vt.dp_partition_device(A, vt.ColumnBlockComponentCostModel(np.inf, 1.0), 4,
                               device=CPU)
    with pytest.raises(ValueError):
        device_dp.dp_inputs(A, vt.model_1dvbc_memory(4, 8), 4,
                            vt.SplitPartition.equi(20, 2), device=CPU)
    with pytest.raises(TypeError):  # device is a required keyword
        vt.dp_partition_device(A, vt.model_1dvbc_memory(4, 8), 4)


def test_the_cpu_launches_no_kernel():
    for k in (dp_ops.dp_table, dp_ops.dp_recurrence, dp_ops.chain_floor):
        k.launches = 0
    plan(csc(sp.random(30, 50, 0.1, random_state=2, format="csc")),
         vt.model_1dvbc_memory(4, 8), 8)
    s = torch.arange(9, dtype=torch.float64)
    assert dp_ops.chain_floor(s, 16).item() == dp_ops.chain_floor_plain(s, 16).item()
    assert dp_ops.dp_table.launches == dp_ops.dp_recurrence.launches == 0
    assert dp_ops.chain_floor.launches == 0
    with pytest.raises(ValueError):
        dp_ops.chain_floor(s, 12)


def test_counterparts_name_both_sides():
    for jax_name, port_name in device_dp.COUNTERPARTS.items():
        assert callable(getattr(jax_dp, jax_name))
        assert callable(getattr(device_dp, port_name))
    assert set(device_dp.COUNTERPARTS) == set(jax_dp.__all__)
    assert vt.dp_partition_device is device_dp.dp_partition_device
