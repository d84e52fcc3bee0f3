"""The stripe TrSpMV kernel beside other builds of the same function.

Times the package's stripe kernel (``csrc/trspmv.cu`` through
:func:`vbcs_tpu_torch.ops.trspmv.tr_spmv`) beside each CUDA source named
on the command line, on the flagship (``blocky_matrix()``: 17.1 MB a
call, L2-resident) and on ``blocky_matrix(**BLOCKY_ABOVE_L2)`` (~250 MB
a call, five times the L2), both through ``VBCOperator.from_csc(A,
W=8)``: back-to-back, every candidate in one ``paired_ms`` set with the
plain version and ``torch.addmv`` on CSR, and L2-flushed.  ``--width``
gives both matrices stripes of another width (``blocky_matrix``'s
``w``; the flagship's is 8).  Each source
is compiled by ``nvcc`` into a library of its own under ``build/`` and
held against the plain version first (``|Δ| / max|y| <= 2e-5``); two
launches of each must agree bitwise.

``--cells`` times the shapes of the benchmark's two TrSpMV cells instead
(``spbench/``: ``blocky_w8.trmul_stream``, the random-row blocky family
at ``L = 640,000``, ``tr_mul(x, 1, 0.5, y)``; ``hpcg_27pt_144.cg_sync``,
HPCG's 27-point stencil at 144^3, ``mul(x)``), each relabeled by RCM
(``from_csc(A, W=8, reorder="always")``: the pack HPCG's cell keeps
under auto-RCM, and ``blocky_w8``'s under the earlier rule), on three
formats of its packed direction: (a) ``natural``, the natural view the
cell runs (rows ``perm[idx]``, y through ``col_out``); (b)
``relabeled``, the relabeled pack itself (x and y in its order, no
``col_out``); (c) ``window``, (a) with every block row masked into the
first ``WINDOW_ROWS`` rows (1 MB of x, surely in the L2).  (a) against
(b) and (c) splits the scattered x and y from the map's own cost.  Then
``UNPERMUTED``, the pack ``blocky_w8``'s cell runs under the port's
auto-RCM rule (``reorder="never"``: 8-wide stripes, the float4 map), as
one format ``unpermuted``.  Back-to-back only: each call moves 225-900
MB, over 4x the L2.  Then the float64 cell's shape (``F64_CELLS``:
``hpcg_27pt_144_f64.cg_sync``, the same stencil in float64, relabeled as
its cell keeps it): on its natural view, the f64 staged map
beside the semiring route (``ops/semiring.py`` on the operator's flat
format, what an f64 call ran before the f64 map) and the f32 staged map
on the same pattern (the f64 view's values rounded to f32), each held
against its plain version; the bound counts 8 bytes an f64 element.

    python -m vbcs_tpu_torch.tools.stripe_ab [--variant NAME=SRC.cu ...]
        [--columns NAME=SRC.cu ...] [--earlier NAME=SRC.cu ...]
        [--width W | --cells] [--json FILE]

A ``--variant`` source exports ``vbcs_tr_spmv`` with the package's
interface (its runs cut by the package's
:func:`~vbcs_tpu_torch.ops.trspmv.stage_plan`, its map the package's
:func:`~vbcs_tpu_torch.ops.trspmv.thread_map`); a ``--columns`` source
the interface of the kernel before the staged map (``quads`` in place
of the runs, the thread a column through ``col_stripe``: ``git show
9ccbb5a:vbcs_tpu_torch/csrc/trspmv.cu``); an ``--earlier`` source the
interface of the first kernel, which has no ``quads`` argument.  The
cells' matrices come from the benchmark's own generators
(``spbench.gen``).  It needs a CUDA card and prints one line a matrix,
the card's name and power limit, and a JSON record last.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import VBCOperator
from ..ops import _lib
from ..ops.trspmv import stage_plan, thread_map, tr_spmv, tr_spmv_plain
from ..utils import trace
from ..utils.profile import f32_flops, hbm_bandwidth
from ..utils.timing import flushed_ms, paired_ms
from .matrices import BLOCKY_ABOVE_L2, blocky_matrix

__all__ = ["work", "main", "CELLS", "UNPERMUTED", "F64_CELLS", "WINDOW_ROWS"]

TOL = 2e-5  # f32 sums in another order than the plain version's index_add_
TOL_F64 = 1e-14  # f64 sums: fma against the plain version's multiply and add
ALPHA, BETA = 0.5, 0.25
WINDOW_ROWS = 1 << 18  # (c): block rows masked into 1 MB of x
# the benchmark's TrSpMV cells: (generator of spbench/gen, its seed and
# arguments, packed direction, call arguments)
CELLS = {
    "blocky_w8.trmul_stream": ("blocky", 0, dict(L=640_000, w=8, d=8), "transposed",
                               (1.0, 0.5, True)),
    "hpcg_27pt_144.cg_sync": ("hpcg27", None, dict(nx=144, ny=144, nz=144),
                              "forward", (None, None, False)),
}
# the cells of CELLS whose unpermuted pack --cells times too
UNPERMUTED = ("blocky_w8.trmul_stream",)
# the float64 TrSpMV cell, as CELLS
F64_CELLS = {
    "hpcg_27pt_144_f64.cg_sync": ("hpcg27", None,
                                  dict(nx=144, ny=144, nz=144, dtype="float64"),
                                  "forward", (None, None, False)),
}


def cell_matrix(label):
    """The matrix of a TrSpMV cell (``CELLS`` or ``F64_CELLS``), from
    ``spbench/gen``."""
    import importlib

    gen, seed, kw, _, _ = {**CELLS, **F64_CELLS}[label]
    return importlib.import_module(f"spbench.gen.{gen}").generate(seed, **kw)


def work(fmt, nnz: int, elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of ``y = alpha*A.T@x + beta*y`` on ``fmt``'s matrix
    with ``nnz`` nonzeros, as ``chip_smoke.tr_spmv_work`` counts them:
    each nonzero's value, the stripe splits, block pointers and block
    rows, x, y in and y out once (values and vectors at ``elem`` bytes an
    element); an FMA a nonzero and the scaling of each output."""
    index = sum(t.numel() * t.element_size() for t in (fmt.spl, fmt.pos, fmt.idx))
    return elem * nnz + index + elem * (fmt.m + 2 * fmt.n), 2 * nnz + 3 * fmt.n


def _build(named: list[tuple[str, str, str]]) -> dict:
    """Compile each (name, interface, source) into ``build/stripe_ab_<name>.so``
    (all at once) and load it with its ``vbcs_tr_spmv`` typed: name ->
    (interface, launcher)."""
    out_dir = os.path.dirname(_lib.SO)
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"stripe_ab_{name}.so") for name, _, _ in named}
    if named:
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                        libs[name], src] for name, _, src in named])
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    loaded = {}
    for name, kind, _ in named:
        fn = ctypes.CDLL(libs[name]).vbcs_tr_spmv
        fn.argtypes = [i32] * (1 if kind == "earlier" else 3) + [vp] * 9 + [
            f32, f32, vp, vp]
        fn.restype = i32
        loaded[name] = (kind, fn)
    return loaded


def _call(kind, fn, fmt, xt, yt, alpha=ALPHA, beta=BETA):
    """A closure launching another build on ``fmt`` (a new output each
    call; ``yt`` None: no beta term)."""
    ptrs = [fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.idx.data_ptr(),
            fmt.ofs.data_ptr()]
    if kind == "variant":
        runs = stage_plan(fmt) if thread_map(fmt) == "staged" else None
        head = [fmt.n, fmt.L, 0 if runs is None else runs.shape[0] - 1,
                None if runs is None else runs.data_ptr()]
    else:  # a thread a column, through col_stripe
        head = [fmt.n, fmt.L, int(fmt.quad_widths)] if kind == "columns" else [fmt.n]
        ptrs.append(fmt.col_stripe.data_ptr())

    def run():
        out = torch.empty(fmt.n, dtype=torch.float32, device=xt.device)
        rc = fn(*head, *ptrs, None if fmt.col_out is None else fmt.col_out.data_ptr(),
                fmt.val.data_ptr(), xt.data_ptr(),
                None if yt is None else yt.data_ptr(),
                1.0 if alpha is None else alpha, 0.0 if yt is None else beta,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1e-6, float(b.abs().max())))


def _case(label, A, builds, dev) -> dict:
    op = VBCOperator.from_csc(A, W=8, directions="transposed", device=dev)
    name, fmt, _ = op.route_tr
    if name != "stripe":
        raise RuntimeError(f"{label}: the operator took the {name} route")
    rng = np.random.default_rng(15)
    xt = torch.from_numpy(rng.standard_normal(op.m).astype(np.float32)).to(dev)
    yt = torch.from_numpy(rng.standard_normal(op.n).astype(np.float32)).to(dev)
    AT = sp.csc_matrix(A, dtype=np.float32)
    AT.sort_indices()
    AT = torch.sparse_csr_tensor(
        torch.from_numpy(AT.indptr.astype(np.int32)),
        torch.from_numpy(AT.indices.astype(np.int32)), torch.from_numpy(AT.data),
        size=(op.n, op.m)).to(dev)
    cands = {"package": lambda: tr_spmv(fmt, xt, ALPHA, BETA, yt)}
    cands.update({k: _call(*b, fmt, xt, yt) for k, b in builds.items()})
    plain = tr_spmv_plain(fmt, xt, ALPHA, BETA, yt)
    library = lambda: torch.addmv(yt, AT, xt, beta=BETA, alpha=ALPHA)  # noqa: E731
    errs, same = {}, {}
    ours = cands["package"]()
    for k, f in cands.items():
        a, b = f(), f()
        torch.cuda.synchronize()
        errs[k], same[k] = _rel(a, plain), torch.equal(a, ours)
        if errs[k] > TOL or not torch.equal(a, b):
            raise RuntimeError(f"{label} {k}: off the plain version by {errs[k]:.2e}"
                               f" or two launches differ")
    if _rel(library(), plain) > TOL:
        raise RuntimeError(f"{label}: the library call disagrees with the plain version")
    fns = list(cands.values()) + [lambda: tr_spmv_plain(fmt, xt, ALPHA, BETA, yt),
                                  library]
    warm = paired_ms(fns, dev)
    cold = [flushed_ms(f, dev) for f in list(cands.values()) + [library]]
    nbytes, flops = work(fmt, int(np.count_nonzero(sp.csc_matrix(A).data)))
    bound_ms = max(nbytes / hbm_bandwidth(dev), flops / f32_flops(dev)) * 1e3
    rec = {"columns": op.n, "stripes": fmt.L, "blocks": fmt.idx.numel(),
           "mb_a_call": nbytes / 1e6, "bound_ms": bound_ms,
           "plain_ms": warm[-2], "library_ms": warm[-1],
           "library_flushed_ms": cold[-1],
           "kernels": {k: {"ms": warm[i], "flushed_ms": cold[i], "rel_err": errs[k],
                           "bitwise_package": same[k]}
                       for i, k in enumerate(cands)}}
    print(f"[{label}] {op.n} columns, {fmt.L} stripes, {nbytes / 1e6:.1f} MB a call, "
          f"bound {bound_ms * 1e3:.2f} us; " + "; ".join(
              f"{k} {v['ms'] * 1e3:.2f} us back-to-back ({bound_ms / v['ms']:.3f} of "
              f"the bound), {v['flushed_ms'] * 1e3:.2f} flushed ({bound_ms / v['flushed_ms']:.3f}"
              f"{', bitwise the package' if v['bitwise_package'] else ''})"
              for k, v in rec["kernels"].items())
          + f"; plain {warm[-2] * 1e3:.2f} us; library (torch.addmv, CSR) "
          f"{warm[-1] * 1e3:.2f} us, {cold[-1] * 1e3:.2f} flushed", flush=True)
    return rec


def _cell_case(label, A, direction, call_args, builds, dev, reorder="always") -> dict:
    """(a), (b) and (c) of one cell's packed direction relabeled, or with
    ``reorder="never"`` its unpermuted pack (module docstring): each
    candidate held against the plain version, two launches bitwise,
    bitwise the package on each format, then timed back-to-back."""
    alpha, beta, with_y = call_args
    op = VBCOperator.from_csc(A, W=8, directions=direction, reorder=reorder,
                              device=dev)
    which = "tr" if direction == "transposed" else "fw"
    name, natural, _ = getattr(op, f"route_{which}")
    if name != "stripe" or (op.perm_t is None) != (reorder == "never"):
        raise RuntimeError(f"{label}: route {name}, RCM "
                           f"{'on' if op.perm_t is not None else 'off'}")
    if op.perm_t is None:
        views = {"unpermuted": natural}
    else:
        views = {"natural": natural,
                 "relabeled": getattr(op, f"dev_{which}"),
                 "window": dataclasses.replace(natural,
                                               idx=natural.idx & (WINDOW_ROWS - 1))}
    rng = np.random.default_rng(21)
    xt = torch.from_numpy(rng.standard_normal(op.m).astype(np.float32)).to(dev)
    yt = (torch.from_numpy(rng.standard_normal(op.n).astype(np.float32)).to(dev)
          if with_y else None)
    nnz = int(np.count_nonzero(sp.csc_matrix(A).data))
    rec = {"columns": op.n, "stripes": natural.L, "blocks": natural.idx.numel(),
           "mean_width": op.n / natural.L, "nnz": nnz, "map": thread_map(natural),
           "views": {}}
    for view, fmt in views.items():
        cands = {"package": lambda fmt=fmt: tr_spmv(fmt, xt, alpha, beta, yt)}
        cands.update({k: _call(*b, fmt, xt, yt, alpha, beta)
                      for k, b in builds.items()})
        plain = tr_spmv_plain(fmt, xt, alpha, beta, yt)
        ours = cands["package"]()
        errs, same = {}, {}
        for k, f in cands.items():
            a, b = f(), f()
            torch.cuda.synchronize()
            errs[k], same[k] = _rel(a, plain), torch.equal(a, ours)
            if errs[k] > TOL or not torch.equal(a, b):
                raise RuntimeError(f"{label} {view} {k}: off the plain version by "
                                   f"{errs[k]:.2e} or two launches differ")
        del plain
        warm = paired_ms(list(cands.values()), dev)
        nbytes, flops = work(fmt, nnz)
        bound_ms = max(nbytes / hbm_bandwidth(dev), flops / f32_flops(dev)) * 1e3
        rec["views"][view] = {
            "mb_a_call": nbytes / 1e6, "bound_ms": bound_ms,
            "kernels": {k: {"ms": warm[i], "rel_err": errs[k],
                            "bitwise_package": same[k]}
                        for i, k in enumerate(cands)}}
        print(f"[{label} {view}] {op.n} columns, {fmt.L} stripes of mean width "
              f"{op.n / fmt.L:.3f}, {fmt.idx.numel()} blocks, {nbytes / 1e6:.1f} MB "
              f"a call, bound {bound_ms * 1e3:.2f} us; " + "; ".join(
                  f"{k} {warm[i] * 1e3:.2f} us ({bound_ms / warm[i]:.3f} of the bound"
                  f"{', bitwise the package' if same[k] else ''})"
                  for i, k in enumerate(cands)), flush=True)
    return rec


def _f64_case(label, A, direction, call_args, dev) -> dict:
    """The float64 cell's natural view (module docstring): the f64 staged
    map, the semiring route and the f32 staged map on the same pattern,
    each against its plain version, two launches bitwise, then timed
    back-to-back in one set."""
    from ..ops import semiring

    alpha, beta, with_y = call_args
    op = VBCOperator.from_csc(A, W=8, directions=direction, reorder="always",
                              device=dev)
    which = "tr" if direction == "transposed" else "fw"
    name, nat64, _ = getattr(op, f"route_{which}")
    if name != "stripe" or op.perm_t is None or nat64.val.dtype != torch.float64:
        raise RuntimeError(f"{label}: route {name}, values {nat64.val.dtype}, RCM "
                           f"{'on' if op.perm_t is not None else 'off'}")
    nat32 = dataclasses.replace(nat64, val=nat64.val.float())
    semi = getattr(op, f"semi_{which}")
    rng = np.random.default_rng(21)
    x64 = torch.from_numpy(rng.standard_normal(op.m)).to(dev)
    y64 = torch.from_numpy(rng.standard_normal(op.n)).to(dev) if with_y else None
    x32, y32 = x64.float(), None if y64 is None else y64.float()

    def semiring_call():
        out = semiring.tr_spmv(semi, x64)
        if alpha is not None:
            out = out * alpha
        return out if y64 is None else out + beta * y64

    cands = {"f64_staged": lambda: tr_spmv(nat64, x64, alpha, beta, y64),
             "semiring": semiring_call,
             "f32_staged": lambda: tr_spmv(nat32, x32, alpha, beta, y32)}
    plain64 = tr_spmv_plain(nat64, x64, alpha, beta, y64)
    plain32 = tr_spmv_plain(nat32, x32, alpha, beta, y32)
    errs, same = {}, {}
    for k, f in cands.items():
        a, b = f(), f()
        torch.cuda.synchronize()
        plain, tol = (plain32, TOL) if k == "f32_staged" else (plain64, TOL_F64)
        errs[k], same[k] = _rel(a, plain), torch.equal(a, b)
        if errs[k] > tol or (k != "semiring" and not same[k]):
            raise RuntimeError(f"{label} {k}: off the plain version by {errs[k]:.2e}"
                               f" or two launches differ")
    del plain64, plain32
    before = trace.launches_by_map()
    cands["f64_staged"]()
    after = trace.launches_by_map()
    if after["staged_f64"] != before["staged_f64"] + 1:
        raise RuntimeError(f"{label}: the f64 call launched {after}")
    warm = paired_ms(list(cands.values()), dev)
    nnz = int(np.count_nonzero(sp.csc_matrix(A).data))
    rec = {"columns": op.n, "stripes": nat64.L, "blocks": nat64.idx.numel(),
           "mean_width": op.n / nat64.L, "nnz": nnz, "runs_f64": stage_plan(nat64).shape[0] - 1,
           "runs_f32": stage_plan(nat32).shape[0] - 1, "kernels": {}}
    for i, k in enumerate(cands):
        elem = 4 if k == "f32_staged" else 8
        nbytes, flops = work(nat64, nnz, elem)
        peak = f32_flops(dev) if elem == 4 else f32_flops(dev) / 2
        bound_ms = max(nbytes / hbm_bandwidth(dev), flops / peak) * 1e3
        rec["kernels"][k] = {"ms": warm[i], "rel_err": errs[k], "bitwise_twice": same[k],
                             "mb_a_call": nbytes / 1e6, "bound_ms": bound_ms}
    print(f"[{label} natural] {op.n} columns, {nat64.L} stripes of mean width "
          f"{op.n / nat64.L:.3f}, {nat64.idx.numel()} blocks, runs f64 {rec['runs_f64']} / "
          f"f32 {rec['runs_f32']}; " + "; ".join(
              f"{k} {v['ms'] * 1e3:.2f} us ({v['mb_a_call']:.1f} MB, "
              f"{v['bound_ms'] / v['ms']:.3f} of the bound, rel_err {v['rel_err']:.2e})"
              for k, v in rec["kernels"].items()), flush=True)
    return rec


def _named(values, kind):
    out = []
    for v in values or []:
        name, sep, src = v.partition("=")
        if not sep or not name.isidentifier() or not os.path.isfile(src):
            raise SystemExit(f"expected NAME=SRC.cu with an existing source, got {v!r}")
        out.append((name, kind, src))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append",
                    help="NAME=SRC.cu, the package's interface")
    ap.add_argument("--columns", action="append",
                    help="NAME=SRC.cu, the interface before the staged map")
    ap.add_argument("--earlier", action="append",
                    help="NAME=SRC.cu, the interface without quads")
    shapes = ap.add_mutually_exclusive_group()
    shapes.add_argument("--width", type=int, default=8,
                        help="blocky_matrix's stripe width w (default 8, the flagship's)")
    shapes.add_argument("--cells", action="store_true",
                        help="the benchmark's TrSpMV cells' shapes, (a)-(c)")
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stripe_ab needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _lib.load()
    builds = _build(_named(args.variant, "variant") + _named(args.columns, "columns")
                    + _named(args.earlier, "earlier"))
    if args.cells:
        rec = {"card": smi, "cells": {
            label: _cell_case(label, cell_matrix(label), direction, call_args, builds,
                              dev)
            for label, (_, _, _, direction, call_args) in CELLS.items()}}
        rec["unpermuted"] = {
            label: _cell_case(label, cell_matrix(label), CELLS[label][3], CELLS[label][4],
                              builds, dev, "never")
            for label in UNPERMUTED}
        rec["f64_cells"] = {
            label: _f64_case(label, cell_matrix(label), direction, call_args, dev)
            for label, (_, _, _, direction, call_args) in F64_CELLS.items()}
    else:
        w = dict(w=args.width)
        rec = {"card": smi, "w": args.width,
               "flagship": _case(f"blocky_matrix({w})", blocky_matrix(**w), builds, dev),
               "above_l2": _case(f"blocky_matrix({BLOCKY_ABOVE_L2 | w})",
                                 blocky_matrix(**BLOCKY_ABOVE_L2, **w), builds, dev)}
    print(smi)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
