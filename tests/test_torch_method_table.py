"""The method table (``vbcs_tpu_torch/tools/method_table.py``), the port
of ``bench_tools/test_table.py``, on the CPU (``--device cpu``: the
runtimes are not measured there, or come from an injected timer).

The time models are fit to injected laws (the autotuner's ``measure=``),
so every row of the JAX table is present: the CSC baseline, the five 1-D
planners and the four 2-D ones.  Each row's y is checked against the f64
product inside the tool, and ``memory_B`` equals the host bytes of the
JAX package's packs under the same planners.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu as v
from corpus import load_corpus
from vbcs_tpu.models import autotune as aj
from vbcs_tpu_torch.models import autotune as at
from vbcs_tpu_torch.tools import matrices
from vbcs_tpu_torch.tools import method_table as mt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402

W = 3
A_ROW = np.array([4.0, 6.0, 7.0])
A_COL = np.array([8.0, 9.0, 11.0])
B_GRID = np.array([[1.0, 2.0, 3.0], [1.5, 3.5, 6.0], [2.0, 4.0, 7.5]])
FIT = dict(target_bytes=1 << 18, device="cpu")


def law_1d(B, w):
    return (12.0 * len(B.Phi) + (1.0 + w) * B.num_blocks) * 1e-9


def law_2d(B2, u, w):
    return (A_ROW[u - 1] * len(B2.Pi) + A_COL[w - 1] * len(B2.Phi)
            + B_GRID[u - 1, w - 1] * B2.num_blocks) * 1e-9


def banded(m, n, d, band, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(n * d).astype(np.float32),
                       (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


@pytest.fixture
def models(tmp_path, monkeypatch):
    """The 1-D (W=3) and 2-D (U=W=3) time models, fit to the injected laws
    (their cache under ``tmp_path``)."""
    monkeypatch.setenv("VBCS_CACHE", str(tmp_path))
    m1 = at.model_1dvbc_trspmv_time(W, measure=law_1d, **FIT)
    m2 = at.model_vbc_trspmv_time(W, W, rank=3, measure=law_2d, **FIT)
    return m1, m2


def jax_bytes(A, m1):
    """The JAX table's memory_B for the same planners, in row order."""
    C = v.CSC.from_scipy(A)
    t = aj.autotune_1dvbc_trspmv(W, measure=law_1d, target_bytes=1 << 18,
                                 cache=False)
    mj = v.ColumnBlockComponentCostModel(alpha_col=t[0], beta_col=t[1],
                                         gamma_col=t[2])
    t2 = aj.autotune_vbc_trspmv(W, W, measure=law_2d, target_bytes=1 << 18,
                                rank=3, cache=False)
    m2 = v.BlockComponentCostModel(alpha_row=t2[0], alpha_col=t2[1],
                                   beta_row=t2[2], beta_col=t2[3])
    mem, blocks = v.model_1dvbc_memory(4, 8), v.model_1dvbc_blocks()
    one = [v.StrictChunker(W), v.OverlapChunker(0.9, W),
           v.DynamicTotalChunker(v.ConstrainedCost(blocks, v.VertexCount(), W)),
           v.DynamicTotalChunker(mem, W), v.DynamicTotalChunker(mj, W)]
    two = [v.AlternatingPacker(v.StrictChunker(W), v.StrictChunker(W)),
           v.AlternatingPacker(v.OverlapChunker(0.7, W), v.OverlapChunker(0.7, W)),
           v.default_2d_partitioner(W, W, 4, 8),
           v.AlternatingPacker(
               v.EquiChunker(1), v.EquiChunker(1),
               v.DynamicTotalChunker(v.ConstrainedCost(m2, v.VertexCount(), W)),
               v.DynamicTotalChunker(v.ConstrainedCost(m2.permuted(),
                                                       v.VertexCount(), W)),
               v.DynamicTotalChunker(v.ConstrainedCost(m2, v.VertexCount(), W)))]
    return ([C.memory_bytes()]
            + [v.vbc1d(C, W, v.pack_stripe(C, p)).memory_bytes() for p in one]
            + [v.vbc2d(C, W, W, p).memory_bytes() for p in two])


def test_table_on_a_banded_matrix(models):
    A = banded(600, 600, 6, 40, 3)
    m1, m2 = models
    seen = []
    rows = mt.build_table(A, W, device="cpu", mdl_time=m1, mdl_time2=m2,
                          timer=lambda k, f, c: 10.0, log=seen.append)
    assert [r.method for r in rows] == [
        "CSC baseline", "strict", "overlap 0.9", "min blocks", "min memory",
        "min time (autotuned)", "strict 2D", "overlap 2D 0.7",
        "dynamic memory 2D", "min time 2D (autotuned)"]
    assert len(seen) == len(rows)
    assert [r.memory_B for r in rows] == jax_bytes(A, m1)
    for r in rows:
        assert r.y_err <= 2e-4 and r.runtime_us == 10.0
        assert r.kernel in ("csc", "stripe", "scatter", "view", "tile2d")
    for r in rows[1:6] + rows[9:]:  # the rows the time models predict
        assert np.isfinite(r.pred_us) and r.p_over_m == r.pred_us / 10.0
    assert np.isnan(rows[0].pred_us)
    # the min-time row's model value is its prediction, in ns
    assert rows[5].model == pytest.approx(rows[5].pred_us * 1e3)
    assert seen == [mt.format_row(r, A.nnz) for r in rows]
    assert all(line.startswith(r.method) for line, r in zip(seen, rows))


def test_table_refuses_a_wrong_y(models, monkeypatch):
    """The tool checks each row's y: a route that computes the wrong
    product fails the table."""
    from vbcs_tpu_torch import operator

    real = operator.route_tr_spmv

    def wrong(B, device, *a):
        name, fmt, call = real(B, device, *a)
        return name, fmt, lambda f, x, *r: 2 * call(f, x, *r)

    monkeypatch.setattr(mt, "route_tr_spmv", wrong)
    with pytest.raises(AssertionError, match="strict"):
        mt.build_table(banded(200, 200, 4, 20, 4), W, device="cpu", csc=False)


def test_cli_on_the_cpu(models, capsys, monkeypatch):
    """``--device cpu`` on a corpus matrix: the models' rows (here the
    injected laws' models, where the tool reads the cache), the runtime
    columns not measured (nan)."""
    monkeypatch.setattr(mt, "time_models", lambda W, device, time_model=True,
                        time_model_2d=True: models if time_model else (None, None))
    rows = mt.main(["--matrix", "HB/can_292", "--w", str(W), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cpu: runtimes not measured" in out and mt.HEADER in out
    assert len(rows) == 10 and all(np.isnan(r.runtime_us) for r in rows)
    A = load_corpus()["HB/can_292"].astype(np.float32)
    assert rows[0].memory_B == v.CSC.from_scipy(A).memory_bytes()
    rows = mt.main(["--matrix", "HB/can_292", "--w", str(W), "--device", "cpu",
                    "--no-time-model"])
    assert len(rows) == 8


def test_cli_needs_the_cache_or_no_time_model(tmp_path, monkeypatch):
    """The table reads cached models only: an empty cache raises, for the
    1-D model and, once that is cached, for the 2-D one."""
    monkeypatch.setenv("VBCS_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mt.main(["--matrix", "HB/can_292", "--device", "cpu"])
    path = at.cache_path_1d(W, device="cpu")
    at.autotune_1dvbc_trspmv(W, measure=law_1d, target_bytes=1 << 18,
                             cache=True, device="cpu")
    os.replace(at.cache_path_1d(W, target_bytes=1 << 18, device="cpu"), path)
    with pytest.raises(FileNotFoundError, match="2-D"):
        mt.time_models(W, "cpu")
    mdl, mdl2 = mt.time_models(W, "cpu", time_model_2d=False)
    assert mdl is not None and mdl2 is None


@pytest.mark.parametrize("name,kw", [
    ("blocky_matrix", {}),
    ("blocky_matrix", dict(L=500, w=3, d=4, band=20, seed=2)),
    ("fem_matrix", {}),
    ("fem_matrix", dict(k=17, seed=1)),
])
def test_generators_match_the_bench(name, kw):
    """The tool's own copies of the bench's generators give its matrices,
    bitwise: same shape, structure, values and dtype."""
    got, want = getattr(matrices, name)(**kw), getattr(bench, name)(**kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


def test_tool_reads_no_file_outside_the_package(monkeypatch):
    """``--matrix synthetic|fem`` builds its matrix from the package alone:
    no ``bench`` module is imported for it."""
    monkeypatch.delitem(sys.modules, "bench", raising=False)
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if os.path.abspath(p) != mt.ROOT])
    for name in ("synthetic", "fem"):
        title, A = mt.load_matrix(name)
        assert A.dtype == np.float32 and A.nnz > 0
    assert "bench" not in sys.modules
