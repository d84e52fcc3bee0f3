"""The method table: per matrix, planner x {setup, memory, runtime, predicted}.

Port of ``bench_tools/test_table.py``, the analog of the reference's
``bin/test_table.jl``.  Run from the repository root::

    python -m vbcs_tpu_torch.tools.method_table --matrix synthetic --w 8
    python -m vbcs_tpu_torch.tools.method_table --matrix fem --no-time-model
    python -m vbcs_tpu_torch.tools.method_table --matrix HB/can_292 --device cpu

``--matrix`` is ``synthetic`` (``tools/matrices.blocky_matrix()``, the
flagship), ``fem`` (``tools/matrices.fem_matrix()``, the scrambled 320 x 320
grid) or a name in the repository's ``data/corpus.npz``.  Rows, in the JAX table's order: the CSC baseline
(``ops/csr.py``), then strict, overlap 0.9, min blocks, min memory and min
time (autotuned) 1-D plans at width ``W``, then the strict, overlap 0.7,
dynamic-memory and min-time (autotuned) 2-D plans at ``U = W``.  Columns:

* ``setup_s``: plan + pack on the host;
* ``memory_B``: the packed format's host bytes (the CSC's for the baseline);
* ``runtime_us``: one call of the TrSpMV that ``tr_mul`` runs for the plan
  (``operator.route_tr_spmv``/``route_tr_spmv_2d``; the route's name is in
  the label), timed on the card with CUDA events as a chain of
  ``y = call(fmt, x, 1, 0.5, y)``, the way the autotuner times its samples;
  "nan" on a CPU device (no device metric);
* ``gnnz_s``: the matrix's nonzeros over the runtime;
* ``model``: the plan's value under the planner's own objective;
* ``pred_us``: the autotuned time model's prediction for the plan (the
  reference's fidelity column), and ``p/m`` its ratio to the runtime.

Each row's y (``A.T @ x``, f32) is checked against the f64 product, as
the JAX table does.  The time models come from the autotuner's cache at
its default sizes (``models/autotune.py``: fit them once with
``vbcs_tpu_torch.autotune_1dvbc_trspmv(W, device="cuda")`` and
``autotune_vbc_trspmv(W, W, device="cuda")``); ``--no-time-model`` skips
the min-time rows, ``--no-2d-time-model`` the 2-D one.  It runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import api
from ..formats.csc import CSC
from ..models import autotune
from ..models.cost import (ConstrainedCost, VertexCount, model_1dvbc_blocks,
                           model_1dvbc_memory, model_vbc_memory,
                           row_component_value, total_value)
from ..operator import route_tr_spmv, route_tr_spmv_2d
from ..ops.csr import CSCDevice, csc_tr_spmv
from ..plan.alternating import AlternatingPacker, pack_stripe
from ..plan.chunkers import EquiChunker, OverlapChunker, StrictChunker
from ..plan.dynamic import DynamicTotalChunker
from . import matrices

__all__ = ["Row", "methods_1d", "methods_2d", "build_table", "format_row",
           "load_matrix", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass
class Row:
    method: str
    kernel: str  # the route tr_mul takes ("csc" for the baseline)
    setup_s: float
    memory_B: int
    runtime_us: float  # nan where not measured
    model: float
    pred_us: float  # nan without a time model
    y_err: float  # |y - A.T @ x| / max|A.T @ x| against the f64 product

    def gnnz_s(self, nnz: int) -> float:
        return nnz / self.runtime_us / 1e3

    @property
    def p_over_m(self) -> float:
        return self.pred_us / self.runtime_us


def methods_1d(W: int, mdl_time=None) -> list:
    """``(label, planner, objective)`` of the 1-D rows
    (``bench_tools/test_table.py:102-116``); the min-time row only with a
    time model."""
    blocks = model_1dvbc_blocks()
    memory = model_1dvbc_memory(4, 8)  # f32 values, int64 host indices
    rows = [
        ("strict", StrictChunker(W), memory),
        ("overlap 0.9", OverlapChunker(0.9, W), memory),
        ("min blocks", DynamicTotalChunker(
            ConstrainedCost(blocks, VertexCount(), W)), blocks),
        ("min memory", DynamicTotalChunker(memory, W), memory),
    ]
    if mdl_time is not None:
        rows.append(("min time (autotuned)", DynamicTotalChunker(mdl_time, W),
                     mdl_time))
    return rows


def _model_sizes(mdl) -> tuple[int, int]:
    """The largest (u, w) a 2-D time model has table entries for."""
    return int(np.size(mdl.alpha_row)), int(np.size(mdl.alpha_col))


def methods_2d(W: int, mdl_time2=None) -> list:
    """``(label, planner, objective)`` of the 2-D rows at ``U = W``
    (``bench_tools/test_table.py:143-168``).  The min-time planner caps
    heights and widths at the sizes its model was fit to, as the JAX
    table's ``ConstrainedCost`` caps them at ``W``."""
    mem2 = model_vbc_memory(4, 8)
    rows = [
        ("strict 2D", AlternatingPacker(StrictChunker(W), StrictChunker(W)), mem2),
        ("overlap 2D 0.7", AlternatingPacker(OverlapChunker(0.7, W),
                                             OverlapChunker(0.7, W)), mem2),
        ("dynamic memory 2D", api.default_2d_partitioner(W, W, 4, 8), mem2),
    ]
    if mdl_time2 is not None:
        u_cap, w_cap = (min(W, s) for s in _model_sizes(mdl_time2))
        rows.append(("min time 2D (autotuned)", AlternatingPacker(
            EquiChunker(1), EquiChunker(1),
            DynamicTotalChunker(ConstrainedCost(mdl_time2, VertexCount(), w_cap)),
            DynamicTotalChunker(ConstrainedCost(mdl_time2.permuted(),
                                                VertexCount(), u_cap)),
            DynamicTotalChunker(ConstrainedCost(mdl_time2, VertexCount(), w_cap)),
        ), mdl_time2))
    return rows


def _chain_us(fmt, call, device) -> float:
    """Device microseconds a call takes, as the autotuner times it (the
    CSC baseline's call ignores the chain's y and reads x, y out and its
    three arrays)."""
    nbytes = (fmt.nbytes + 4 * (fmt.m + fmt.n) if isinstance(fmt, CSCDevice)
              else autotune._call_bytes(fmt))
    t = autotune._chain_s(call, fmt, device, nbytes)
    return math.nan if t is None else t * 1e6


def _y_err(label: str, got: torch.Tensor, want: np.ndarray) -> float:
    """``|y - want| / max(1, max|want|)``; raises where the JAX table's
    check (``allclose`` at rtol 1e-4, atol 1e-4 * max(1, max|want|))
    fails."""
    got = got.detach().cpu().numpy().astype(np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
        raise AssertionError(f"{label}: y is off the f64 product")
    return float(np.abs(got - want).max(initial=0.0)) / scale


def build_table(A, W: int = 8, *, device, mdl_time=None, mdl_time2=None,
                csc: bool = True, timer=None, log=None) -> list[Row]:
    """The table's rows for the f32 matrix ``A`` (anything scipy can
    convert) on ``device``.  ``mdl_time``/``mdl_time2`` are the 1-D and
    2-D time models (None skips their rows and the prediction column).
    ``timer(kernel_name, fmt, call) -> us`` times a routed call; by
    default a CUDA device times it as the autotuner does and a CPU device
    writes nan.  ``log(str)`` is called after each row."""
    device = torch.device(device)
    if timer is None:
        timer = (lambda k, f, c: _chain_us(f, c, device)) \
            if device.type == "cuda" else (lambda k, f, c: math.nan)
    A_sp = sp.csc_matrix(A, dtype=np.float32)
    C = CSC.from_scipy(A_sp)
    x_np = np.random.default_rng(1).standard_normal(C.m).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    want = A_sp.T.astype(np.float64) @ x_np.astype(np.float64)
    rows = []

    def add(row):
        rows.append(row)
        if log is not None:
            log(format_row(row, C.nnz))

    if csc:
        cdev = CSCDevice.from_host(C, dtype=np.float32, device=device)
        err = _y_err("CSC baseline", csc_tr_spmv(cdev, x), want)
        t = timer("csc", cdev, lambda f, xx, *_: csc_tr_spmv(f, xx))
        add(Row("CSC baseline", "csc", 0.0, C.memory_bytes(), t, math.nan,
                math.nan, err))

    for label, method, objective in methods_1d(W, mdl_time):
        t0 = time.perf_counter()
        Phi = pack_stripe(C, method)
        B = api.vbc1d(C, W, Phi)
        setup = time.perf_counter() - t0
        kname, fmt, call = route_tr_spmv(B, device)
        err = _y_err(label, call(fmt, x), want)
        pred = (total_value(C, Phi, mdl_time) / 1e3 if mdl_time is not None
                else math.nan)
        add(Row(label, kname, setup, B.memory_bytes(), timer(kname, fmt, call),
                total_value(C, Phi, objective), pred, err))

    for label, method, objective in methods_2d(W, mdl_time2):
        t0 = time.perf_counter()
        B2 = api.vbc2d(C, W, W, method)
        setup = time.perf_counter() - t0
        kname, fmt, call = route_tr_spmv_2d(B2, device)
        err = _y_err(label, call(fmt, x), want)
        model = (total_value(C, B2.Phi, objective, Pi=B2.Pi)
                 + row_component_value(B2.Pi, objective))
        pred = math.nan
        if mdl_time2 is not None:
            u_max, w_max = _model_sizes(mdl_time2)
            if (B2.Pi.widths().max(initial=0) <= u_max
                    and B2.Phi.widths().max(initial=0) <= w_max):
                pred = (total_value(C, B2.Phi, mdl_time2, Pi=B2.Pi)
                        + row_component_value(B2.Pi, mdl_time2)) / 1e3
        add(Row(label, kname, setup, B2.memory_bytes(), timer(kname, fmt, call),
                model, pred, err))
    return rows


HEADER = (f"{'method':40s} {'setup_s':>8s} {'memory_B':>12s} {'runtime_us':>11s} "
          f"{'gnnz_s':>7s} {'model':>12s} {'pred_us':>8s} {'p/m':>5s}")


def format_row(row: Row, nnz: int) -> str:
    label = f"{row.method} [{row.kernel}]"
    return (f"{label:40s} {row.setup_s:8.3f} {row.memory_B:12d} "
            f"{row.runtime_us:11.2f} {row.gnnz_s(nnz):7.2f} {row.model:12.0f} "
            f"{row.pred_us:8.2f} {row.p_over_m:5.2f}")


def _corpus(name: str):
    z = np.load(os.path.join(ROOT, "data", "corpus.npz"))
    key = name.replace("/", "__")
    if f"{key}__shape" not in z.files:
        raise SystemExit(f"no matrix {name!r} in data/corpus.npz")
    return sp.csc_matrix(
        (z[f"{key}__data"], z[f"{key}__indices"], z[f"{key}__indptr"]),
        shape=tuple(z[f"{key}__shape"]))


def load_matrix(name: str):
    """``(title, f32 CSC)`` for ``--matrix``: the JAX bench's generators
    (``tools/matrices.py``) or a corpus matrix."""
    if name == "synthetic":
        return "synthetic ct20stif-like (banded blocky)", matrices.blocky_matrix()
    if name == "fem":
        return ("scrambled 5-point FEM (thermal1-like, 320x320 grid)",
                matrices.fem_matrix().astype(np.float32))
    return name, _corpus(name).astype(np.float32)


def time_models(W: int, device, *, time_model=True, time_model_2d=True):
    """The cached 1-D (W) and 2-D (U = W, rank 3) time models for
    ``device`` at the autotuner's default sizes (None where skipped); a
    missing cache raises ``FileNotFoundError`` (the table never starts a
    fit)."""
    mdl = mdl2 = None
    if time_model:
        mdl = autotune.model_1dvbc_trspmv_time(W, require_cache=True, device=device)
    if time_model and time_model_2d:
        path = autotune.cache_path_2d(W, W, device=device)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no cached 2-D autotune tables for this device ({path}); fit "
                f"them with autotune_vbc_trspmv({W}, {W}), or pass "
                f"--no-2d-time-model")
        mdl2 = autotune.model_vbc_trspmv_time(W, W, rank=3, device=device)
    return mdl, mdl2


def main(argv=None) -> list[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--matrix", default="synthetic")
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-time-model", action="store_true")
    ap.add_argument("--no-2d-time-model", action="store_true")
    ap.add_argument("--no-csc", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu for the table "
                         "without runtimes")
    title, A = load_matrix(args.matrix)
    mdl, mdl2 = time_models(args.w, device, time_model=not args.no_time_model,
                            time_model_2d=not args.no_2d_time_model)
    nnz = int(A.nnz)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu: runtimes not measured")
    print(f"\n=== {title}  {A.shape[0]}x{A.shape[1]}  nnz={nnz}  W={args.w}  "
          f"on {where} ===\n{HEADER}", flush=True)
    return build_table(A, args.w, device=device, mdl_time=mdl, mdl_time2=mdl2,
                       csc=not args.no_csc,
                       log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
