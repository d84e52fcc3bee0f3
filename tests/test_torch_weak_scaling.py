"""``vbcs_tpu_torch.tools.weak_scaling`` (the port of
``bench_tools/weak_scaling.py``) on the CPU: gloo worlds of 1 and 2 ranks
at a tiny ``l0``, every path's ``y`` against the f64 product, the halo
sizes from the port's own halo plan, and the analytic model recomputed in
NumPy.  Nothing is timed on the CPU; the card's rows come from
``chip_smoke.py`` phase 17."""

import json

import numpy as np
import pytest

from vbcs_tpu_torch.api import vbc1d
from vbcs_tpu_torch.entry import TOL
from vbcs_tpu_torch.parallel.shard import plan_halo, split_ranges, stored_per_stripe
from vbcs_tpu_torch.plan.chunkers import EquiChunker
from vbcs_tpu_torch.tools import weak_scaling as ws
from vbcs_tpu_torch.tools.matrices import blocky_matrix

L0 = 40


@pytest.fixture(scope="module")
def rows():
    return ws.measure(L0, 2, "cpu", reps=2)


def test_rows_cover_each_world_and_path(rows):
    assert [(r["ndev"], r["path"]) for r in rows] == [
        (n, p) for n in (1, 2) for p in ws.PATHS]
    for r in rows:
        assert r["err"] <= TOL and r["backend"] == "gloo" and r["platform"] == "cpu"
        assert r["t_us"] is r["gnnz_s"] is r["efficiency"] is None
        assert r["kernel_us"] is r["kernel_gnnz_s"] is None
        assert not r["shared_card"]
        A = blocky_matrix(L=L0 * r["ndev"])
        assert r["nnz"] == A.nnz


def test_halo_is_the_port_plans(rows):
    for r in rows:
        n = r["ndev"]
        B = vbc1d(blocky_matrix(L=L0 * n), 8, EquiChunker(8))
        plan = plan_halo(B, n, split_ranges(stored_per_stripe(B), n))
        assert r["hmax"] == plan.hmax
        assert r["halo_kib"] == (n - 1) * plan.hmax * 4096 / 1024


def test_analytic_rows_recomputed(rows):
    rate, link = 37.5, 120.0
    model = ws.analytic(rows, rate, link)
    assert model["rate_from"] == "--rate" and model["link_gb_s_assumed"] == link
    halo = [r for r in rows if r["path"] == "halo"]
    assert [m["ndev"] for m in model["rows"]] == [r["ndev"] for r in halo]
    for m, r in zip(model["rows"], halo):
        t_comp = np.float64(r["nnz"]) / r["ndev"] / (rate * 1e9)
        t_halo = np.float64(r["halo_kib"]) * 1024 / (link * 1e9)
        np.testing.assert_allclose(
            [m["compute_us"], m["halo_us"], m["modeled_eff_sequential"],
             m["modeled_eff_overlapped"]],
            [t_comp * 1e6, t_halo * 1e6, t_comp / (t_comp + t_halo),
             t_comp / max(t_comp, t_halo)], rtol=1e-12)


def test_the_model_takes_the_measured_single_card_row(rows):
    """The rate is the N = 1 replicated row's kernel time, not its wall (a
    host-paced call is ~100x its kernel on the card); the wall's rate
    stands beside it."""
    measured = [dict(r, gnnz_s=0.1 if r["ndev"] == 1 else 0.05,
                     kernel_gnnz_s=2.0 if r["ndev"] == 1 else 1.0) for r in rows]
    model = ws.analytic(measured)
    assert model["single_card_gnnz_s"] == 2.0
    assert model["wall_gnnz_s"] == 0.1
    assert model["rate_from"] == "the kernel time of the measured N = 1 row"
    t_comp = [r["nnz"] / r["ndev"] / 2e9 * 1e6 for r in measured if r["path"] == "halo"]
    np.testing.assert_allclose([m["compute_us"] for m in model["rows"]], t_comp,
                               rtol=1e-12)


def test_a_wall_without_a_kernel_time_gives_no_rate(rows):
    """Rows that carry a wall and no kernel time (a path with no kernel)
    do not feed the model: it raises, as without any timing."""
    with pytest.raises(ValueError, match="kernel time"):
        ws.analytic([dict(r, gnnz_s=2.0) for r in rows])


def test_without_a_single_card_rate_the_model_raises(rows):
    with pytest.raises(ValueError, match="N = 1"):
        ws.analytic(rows)  # the CPU rows are untimed
    with pytest.raises(ValueError, match="N = 1"):
        ws.analytic([dict(r, gnnz_s=1.0) for r in rows if r["ndev"] > 1])


def test_world_sizes():
    assert ws.world_sizes(1) == [1]
    assert ws.world_sizes(4) == ws.world_sizes(7) == [1, 2, 4]
    with pytest.raises(ValueError):
        ws.world_sizes(0)


def test_command_line_on_the_cpu(capsys):
    out = ws.main(["--device", "cpu", "--l0", str(L0), "--world", "1",
                   "--rate", "50", "--link-gbs", "100"])
    text = capsys.readouterr().out
    assert "(ASSUMED)" in text and "(--rate)" in text
    line = [l for l in text.splitlines() if l.startswith("WEAK ")][0]
    assert json.loads(line[len("WEAK "):]) == json.loads(json.dumps(out))
    assert out["analytic_model"]["single_card_gnnz_s"] == 50.0
