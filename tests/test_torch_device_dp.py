"""The split-point DP on a torch device (``vbcs_tpu_torch.plan.device_dp``,
``ops/dp.py``) on the CPU, where its kernels run their plain versions:
against the JAX package's ``dp_partition_jit``/``_2d`` (jit on the CPU)
and the host DP ``plan/dynamic.dp_partition`` (the C++ DP), split points
bitwise; the stripe-cost table against a NumPy walk of the host's
counters, bitwise; the recurrence's routes (the (min,+) scan on exact
tables, the checked fold on the scan's back pointers otherwise) against
the serial fold and the host, the checked fold also with guesses wrong on
purpose and past its restart budget; the backtrack by pointer doubling
against the host loop.  The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import sys

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

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import corrupt_guess, fitted_1d  # noqa: E402

CPU = torch.device("cpu")


def csc(A):
    return vt.CSC.from_scipy(sp.csc_matrix(A))


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
    the narrowest stripe (the tables are integers: the scan's route)."""
    A = csc(sp.random(50, 40, 0.2, random_state=3, format="csc"))
    for W in (1, 4, 8):
        mdl = vt.ColumnBlockComponentCostModel(np.arange(1.0, W + 1), 0.0)
        assert device_dp.dp_route(A, mdl, W) == "scan"
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
        pos, grp, wts, alpha, beta, _ = device_dp.dp_inputs(A, model, W, Pi, device=CPU)
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
    if not torch.cuda.is_available():  # the default device is the card: no CPU fallback
        with pytest.raises((AssertionError, RuntimeError)):
            vt.dp_partition_device(A, vt.model_1dvbc_memory(4, 8), 4)


def test_the_cpu_launches_no_kernel():
    kernels = (dp_ops.dp_table, dp_ops.dp_recurrence_serial, dp_ops.dp_recurrence_scan,
               dp_ops.dp_recurrence_checked, dp_ops.chain_floor)
    for k in kernels:
        k.launches = 0
    A = csc(sp.random(30, 50, 0.1, random_state=2, format="csc"))
    plan(A, vt.model_1dvbc_memory(4, 8), 8)
    plan(A, fitted_1d(8), 8)
    s = torch.arange(9, dtype=torch.float64)
    assert dp_ops.chain_floor(s, 16).item() == dp_ops.chain_floor_plain(s, 16).item()
    S = table_like(70, 5, 3, 0.37)
    dp_ops.dp_recurrence_serial(S)
    dp_ops.dp_recurrence_checked(S)
    assert [k.launches for k in kernels] == [0] * len(kernels)
    with pytest.raises(ValueError):
        dp_ops.chain_floor(s, 12)


def test_counterparts_name_both_sides():
    for jax_name, port_name in device_dp.COUNTERPARTS.items():
        assert callable(getattr(jax_dp, jax_name))
        assert callable(getattr(device_dp, port_name))
    assert set(device_dp.COUNTERPARTS) == set(jax_dp.__all__)
    assert vt.dp_partition_device is device_dp.dp_partition_device


# ---- the scan route: the (min,+) scan on exact tables --------------------------

L = dp_ops.SCAN_ROWS


def table_like(n, W, seed, scale=1.0):
    """S [n, W] as the table makes it (inf where w > jp): small multiples of
    ``scale`` (exact; many ties)."""
    rng = np.random.default_rng(seed)
    S = rng.integers(1, 9, (n, W)).astype(np.float64) * scale
    S[np.triu_indices(min(n, W), 1)] = np.inf
    return torch.from_numpy(S)


def scan_sizes(W):
    """n at the scan's edges: none, one row, a chunk and its neighbours,
    several chunks, and two full blocks and a part of a third."""
    B = dp_ops.scan_layout(10 ** 6, W)[3]
    return (0, 1, L - 1, L, L + 1, 5 * L + 3, 2 * B * L + 17)


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 24, 33])
def test_scan_plain_equals_the_serial_fold(W):
    """prev and opt bitwise the serial fold's on exact S: integers and
    binary fractions, with ties."""
    for n in scan_sizes(W):
        for scale in (1.0, 0.25):
            S = table_like(n, W, n + W, scale)
            got = dp_ops.dp_recurrence_scan_plain(S)
            want = dp_ops.dp_recurrence_plain(S)
            assert torch.equal(got[1], want[1]), (n, W, scale)
            assert torch.equal(got[0], want[0]), (n, W, scale)
            assert torch.equal(dp_ops.dp_recurrence(S, exact=True)[0], want[0])


def exact_models(W, m):
    return [(vt.model_1dvbc_memory(4, 8), None),
            (vt.ColumnBlockComponentCostModel(2.0, 1.5), None),
            (vt.model_vbc_memory(4, 8), vt.SplitPartition.equi(m, 3))]


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 24, 33])
def test_scan_route_matches_the_host_dp(W):
    """The exact models take the scan: on the table's S its prev and opt
    are the serial fold's, and the split points the host C++ DP's, at the
    scan's edges of n (the first n columns of a matrix) with empty
    columns among them."""
    A = sp.random(120, 2 * dp_ops.scan_layout(10 ** 6, W)[3] * L + 17, 0.03,
                  random_state=W, format="lil")
    A[:, 3:9] = 0
    A[:, L - 2:L + 2] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    for n in scan_sizes(W)[1:]:
        C = csc(A[:, :n])
        for model, Pi in exact_models(W, C.m):
            assert device_dp.dp_route(C, model, W, Pi) == "scan"
            pos, grp, wts, alpha, beta, exact = device_dp.dp_inputs(C, model, W, Pi,
                                                                    device=CPU)
            assert exact
            S = dp_ops.dp_table(pos, grp, dp_ops.prev_occurrence(pos, grp), wts,
                                alpha, beta, W)
            got = dp_ops.dp_recurrence_scan_plain(S)
            want = dp_ops.dp_recurrence_plain(S)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), (n, W)
            assert device_dp.backtrack(got[0]) == dp_partition(C, model, W,
                                                               row_partition=Pi)
            assert_host(C, model, W, Pi)


def test_routes():
    """Memory models and binary fractions take the scan, fitted time
    models (and any table whose sums can round) the checked fold."""
    A = csc(sp.random(300, 700, 0.02, random_state=0, format="csc"))
    Pi = vt.SplitPartition.equi(300, 4)
    for W in (1, 4, 8, 33):
        assert device_dp.dp_route(A, vt.model_1dvbc_memory(4, 8), W) == "scan"
        assert device_dp.dp_route(A, vt.model_vbc_memory(4, 8), W, Pi) == "scan"
        assert device_dp.dp_route(A, vt.ColumnBlockComponentCostModel(2.0, 1.5), W) == "scan"
        assert device_dp.dp_route(A, fitted_1d(W), W) == "checked"
        assert device_dp.dp_route(A, fitted_2d(W), W, Pi) == "checked"
    third = vt.ColumnBlockComponentCostModel(1.0, 1.0 / 3.0)
    assert device_dp.dp_route(A, third, 8) == "checked"
    # exact but too large: n * max|S| reaches 2^52
    big = vt.ColumnBlockComponentCostModel(2.0 ** 45, 1.0)
    assert device_dp.dp_route(A, big, 8) == "checked"
    assert device_dp.dp_route(A, vt.ColumnBlockComponentCostModel(2.0 ** 30, 1.0), 8) == "scan"
    assert dp_ops.exact_tables([0.5, 0.75], [[1.0, 2.0]], None, 10, 10)
    assert not dp_ops.exact_tables([0.1, 0.75], [[1.0, 2.0]], None, 10, 10)
    assert not dp_ops.exact_tables([1.0], [[1.0]], np.array([[0.1, 1.0]]), 2, 10)
    assert dp_ops.exact_tables([1.0], [[0.5]], np.array([[0.25, 3.0]]), 2, 10)


def test_backtrack_is_the_host_loop():
    rng = np.random.default_rng(5)
    assert device_dp.backtrack(torch.zeros(1, dtype=torch.int64)) == vt.SplitPartition.whole(0)
    for n in (1, 2, 7, 1000, 4097):
        for W in (1, 3, 8):
            prev = np.zeros(n + 1, dtype=np.int64)
            for j in range(1, n + 1):
                prev[j] = j - rng.integers(1, min(W, j) + 1)
            got = device_dp.backtrack(torch.from_numpy(prev))
            assert got == device_dp._backtrack(prev.tolist(), n)


def test_dp_stages_plan_as_the_entry_points():
    A = csc(sp.random(100, 300, 0.05, random_state=6, format="csc"))
    Pi = vt.SplitPartition.equi(100, 4)
    # the route that ran: the host loop where dp_route says "checked"
    for model, W, P, route in ((vt.model_1dvbc_memory(4, 8), 8, None, "scan"),
                               (fitted_1d(8), 8, None, "host"),
                               (vt.model_vbc_memory(4, 8), 4, Pi, "scan"),
                               (fitted_2d(4), 4, Pi, "host")):
        got, stages = device_dp.dp_stages(A, model, W, P, device=CPU)
        assert got == plan(A, model, W, P)
        assert stages["route"] == route
        counters = {"restarts", "rewalked", "folded"}
        assert set(stages) == {"route", *counters, *device_dp.STAGES}
        assert all(stages[k] >= 0.0 for k in device_dp.STAGES)
        # the host loop and the scan restart nothing
        assert all(stages[k] == 0 for k in counters)


# ---- the checked route: the checked speculative fold on fitted tables --------

def synthetics():
    """The banded, blocky and FEM matrices of the checked fold's cases."""
    from vbcs_tpu_torch.tools.matrices import blocky_matrix, fem_matrix
    rng = np.random.default_rng(12)
    m, n, band = 300, 1200, 40
    cols = np.repeat(np.arange(n), 4)
    rows = np.clip(cols * m // n + rng.integers(-band, band + 1, cols.size), 0, m - 1)
    banded = sp.coo_matrix((np.ones(cols.size), (rows, cols)), shape=(m, n))
    return {"banded": csc(banded), "blocky": csc(blocky_matrix(L=150)),
            "fem": csc(fem_matrix(k=24))}


SYNTHETICS = synthetics()


def fitted_table(name, W, two_d):
    A = SYNTHETICS[name]
    model, Pi = ((fitted_2d(W, seed=W), vt.SplitPartition.equi(A.m, 4)) if two_d
                 else (fitted_1d(W, W), None))
    pos, grp, wts, alpha, beta, exact = device_dp.dp_inputs(A, model, W, Pi, device=CPU)
    assert not exact
    return dp_ops.dp_table(pos, grp, dp_ops.prev_occurrence(pos, grp), wts, alpha,
                           beta, W)


def assert_serial(got, S):
    want = dp_ops.dp_recurrence_plain(S)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W", [1, 2, 5, 8, 16, 24, 33])
@pytest.mark.parametrize("name", ["banded", "blocky", "fem"])
def test_checked_plain_equals_the_serial_fold(name, W):
    """On fitted 1-D and 2-D tables, the checked fold on the scan's back
    pointers is the serial fold bit for bit (opt and prev)."""
    for two_d in (False, True):
        S = fitted_table(name, W, two_d)
        guess = dp_ops.dp_recurrence_scan_plain(S)[0]
        got = dp_ops.dp_recurrence_checked_plain(S, guess)
        assert_serial(got, S)
        assert torch.equal(dp_ops.dp_recurrence_checked(S)[2], got[2])
        assert got[2][2] == 0 or got[2][0] == dp_ops.check_budget(S.shape[0])
        assert got[2][0] < 10  # the scan's pointers are near-right


@pytest.mark.parametrize("every", [97, 241])
@pytest.mark.parametrize("W", [2, 5, 8, 16, 33])
def test_checked_plain_restarts_on_wrong_guesses(W, every):
    """Guesses wrong on purpose (every 97th or 241st pointer) restart the
    walk, within the budget, and the result is still the serial fold's;
    each restart re-walks the rest of its chunk and the next chunk."""
    for name in SYNTHETICS:
        S = fitted_table(name, W, False)
        guess = corrupt_guess(dp_ops.dp_recurrence_plain(S)[0], W, every)
        got = dp_ops.dp_recurrence_checked_plain(S, guess)
        assert_serial(got, S)
        restarts, rewalked, folded = got[2].tolist()
        assert 0 < restarts < dp_ops.check_budget(S.shape[0]) and folded == 0
        assert restarts <= rewalked <= 2 * dp_ops.CHECK_ROWS * restarts
        assert torch.equal(dp_ops.dp_recurrence_checked(S, guess)[2], got[2])


@pytest.mark.parametrize("W", [2, 8, 33])
@pytest.mark.parametrize("name", ["banded", "blocky", "fem"])
def test_checked_plain_budget_exhaustion(name, W):
    """Past the restart budget the host-order fold finishes the rows, bit
    for bit: every pointer wrong spends the budget within a few chunks."""
    for two_d in (False, True):
        S = fitted_table(name, W, two_d)
        guess = corrupt_guess(dp_ops.dp_recurrence_plain(S)[0], W, 1)
        got = dp_ops.dp_recurrence_checked_plain(S, guess)
        assert_serial(got, S)
        restarts, rewalked, folded = got[2].tolist()
        assert restarts == dp_ops.check_budget(S.shape[0]) and folded > 0


def test_checked_exact_guess_and_exact_tables():
    """The serial fold's own pointers pass every check (no restart), and on
    exact tables the checked fold equals the scan and the serial fold."""
    S = fitted_table("fem", 8, False)
    exact_guess = dp_ops.dp_recurrence_plain(S)[0]
    got = dp_ops.dp_recurrence_checked_plain(S, exact_guess)
    assert_serial(got, S)
    assert got[2].tolist() == [0, 0, 0]
    for W in (1, 4, 16):
        for n in (1, 2, 63, 700):
            T = table_like(n, W, n + W, 0.25)
            got = dp_ops.dp_recurrence_checked(T)
            assert_serial(got, T)
            assert torch.equal(got[0], dp_ops.dp_recurrence_scan(T)[0])
    empty = torch.zeros((0, 3), dtype=torch.float64)
    prev, opt, stats = dp_ops.dp_recurrence_checked(empty)
    assert prev.tolist() == [0] and opt.tolist() == [0.0] and stats.tolist() == [0, 0, 0]


def test_checked_refusals():
    S = table_like(40, 4, 1, 0.37)
    good = dp_ops.dp_recurrence_plain(S)[0]
    bad_width = good.clone()
    bad_width[10] = 10 - 5  # width 5 > W = 4
    for guess in (bad_width, good[:-1], good.to(torch.int32)):
        with pytest.raises(ValueError):
            dp_ops.dp_recurrence_checked(S, guess)
    with pytest.raises(ValueError):
        dp_ops.dp_recurrence_checked(S.float())


@pytest.mark.parametrize("trial", range(3))
def test_checked_plan_matches_jax_dp_partition_jit(trial):
    """The checked fold's back pointers, backtracked, give the JAX
    package's ``dp_partition_jit`` split points and the host DP's."""
    S_ = sp.random(90, 260, 0.07, random_state=40 + trial, format="csc")
    A = csc(S_)
    for model, jmodel in ((vt.model_1dvbc_memory(8, 8), jcost.model_1dvbc_memory(8, 8)),
                          (vt.ColumnBlockComponentCostModel(2.0, 1.5),
                           jcost.ColumnBlockComponentCostModel(2.0, 1.5))):
        pos, grp, wts, alpha, beta, _ = device_dp.dp_inputs(A, model, 5, device=CPU)
        S = dp_ops.dp_table(pos, grp, dp_ops.prev_occurrence(pos, grp), wts, alpha,
                            beta, 5)
        guess = corrupt_guess(dp_ops.dp_recurrence_scan(S)[0], 5, 13)
        prev = dp_ops.dp_recurrence_checked(S, guess)[0]
        want = jax_dp.dp_partition_jit(JCSC.from_scipy(S_), jmodel, 5)
        np.testing.assert_array_equal(device_dp.backtrack(prev).spl, want.spl)
        np.testing.assert_array_equal(device_dp.backtrack(prev).spl,
                                      dp_partition(A, model, 5).spl)
