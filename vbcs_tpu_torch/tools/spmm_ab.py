"""The stripe SpMM kernel beside other builds of the same function.

Times the package's SpMM (``csrc/spmm.cu`` through
:func:`vbcs_tpu_torch.ops.spmm.tr_spmm`) beside each CUDA source named on
the command line, at every shape an operator runs it (:data:`SHAPES`):
the flagship ``blocky_matrix()``'s ``tr_mul_mat`` at k = 128 and 130 (its
A pack; the JAX operator's v4 and v3 SpMM) and ``mul_mat`` at k = 32 (its A.T pack, mean stripe width 1.17); the
auto-RCM FEM's natural views at k = 32, both directions; the scattered
matrix's ``tr_mul_mat`` at k = 32; the 1-D views of the 2-D operators,
(a) ``blocky2d_matrix()`` under the JAX bench's equi plan and (b) the
flagship under the default planner, ``tr_mul_mat`` at k = 128 and
``mul_mat`` at k = 32.  Every candidate runs in one ``paired_ms`` set
with the plain version and ``CSR @ X`` on the same matrix, warm, and
L2-flushed where X and Y together exceed the L2.  Each source is
compiled by ``nvcc`` into a library of its own under ``build/`` and held
against the plain version first (``|Δ| / max|Y| <= 2e-5``); two launches
of each must agree bitwise, and each record says which builds' ``Y`` it
equals bitwise.

    python -m vbcs_tpu_torch.tools.spmm_ab [--variant NAME=SRC.cu ...]
        [--earlier NAME=SRC.cu ...] [--json FILE]

A ``--variant`` source exports ``vbcs_tr_spmm`` with the package's
interface (given the package's width class and long stripes); an
``--earlier`` source the interface of the kernel the package's replaced,
which has no ``width``, ``quads`` or long-stripe arguments.  It
needs a CUDA card and prints one line a shape, the card's name and power
limit, and a JSON record last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import (AlternatingPacker, EquiChunker, VBC2DOperator, VBCOperator)
from ..formats.device import SPMM_LONG_BLOCKS
from ..ops import _lib
from ..ops.spmm import tr_spmm, tr_spmm_plain
from ..utils.profile import f32_flops, hbm_bandwidth
from ..utils.timing import flushed_ms, paired_ms
from .matrices import blocky2d_matrix, blocky_matrix, fem_matrix, scattered_matrix

__all__ = ["SHAPES", "work", "main"]

TOL = 2e-5  # f32 sums in another order than the plain version's index_add_
L2_BYTES = 50 << 20  # the H100's L2: flushed times where X and Y exceed it

# (shape, operator, its pack, k): the operator's SpMM calls, in the order run
SHAPES = (("flagship tr_mul_mat", "flagship", "tr", 128),
          ("flagship tr_mul_mat", "flagship", "tr", 130),
          ("flagship mul_mat", "flagship", "fw", 32),
          ("FEM tr_mul_mat", "fem", "tr", 32),
          ("FEM mul_mat", "fem", "fw", 32),
          ("scattered tr_mul_mat", "scattered", "tr", 32),
          ("2-D (a) tr_mul_mat", "2d_a", "tr", 128),
          ("2-D (a) mul_mat", "2d_a", "fw", 32),
          ("2-D (b) tr_mul_mat", "2d_b", "tr", 128),
          ("2-D (b) mul_mat", "2d_b", "fw", 32))


def work(fmt, nnz: int, k: int) -> tuple[int, int]:
    """(bytes, flops) that ``Y = M @ X`` needs at ``k`` RHS columns on
    ``fmt``'s matrix ``M`` with ``nnz`` nonzeros, the SpMM's bound here and
    in ``chip_smoke.py``: each nonzero's value, the stripe splits, block
    pointers and block rows, X and Y once; an FMA a nonzero and RHS
    column.  The X rows the blocks re-read are not counted."""
    index = sum(t.numel() * t.element_size() for t in (fmt.spl, fmt.pos, fmt.idx))
    return 4 * nnz + index + 4 * k * (fmt.m + fmt.n), 2 * nnz * k


def operator(name: str, dev):
    """``(A, op, pack)`` of one of :data:`SHAPES`' operators: the matrix,
    the operator built as ``chip_smoke.py`` builds it, and a function of
    ``"tr"``/``"fw"`` giving the SpMM's format."""
    if name == "2d_a":
        A = blocky2d_matrix()
        equi = (AlternatingPacker(EquiChunker(8), EquiChunker(4)),
                AlternatingPacker(EquiChunker(4), EquiChunker(8)))
        op = VBC2DOperator.from_csc(A, 4, 8, *equi, device=dev)
        return A, op, lambda d: getattr(op, f"view_{d}")
    if name == "2d_b":
        A = blocky_matrix()
        op = VBC2DOperator.from_csc(A, 8, 8, device=dev)
        return A, op, lambda d: getattr(op, f"view_{d}")
    A = {"flagship": blocky_matrix,
         "fem": lambda: fem_matrix(k=320),
         "scattered": scattered_matrix}[name]().astype(np.float32)
    op = VBCOperator.from_csc(A, W=8, device=dev)
    return A, op, lambda d: getattr(op, f"nat_{d}")


def csr(M, dev):
    """``M`` (scipy) as a f32 CSR tensor on ``dev``: the library yardstick."""
    M = sp.csr_matrix(M, dtype=np.float32)
    M.sort_indices()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int32)),
        torch.from_numpy(M.indices.astype(np.int32)), torch.from_numpy(M.data),
        size=M.shape).to(dev)


def _build(named: list[tuple[str, str, str]]) -> dict:
    """Compile each (name, interface, source) into ``build/spmm_ab_<name>.so``
    (all at once) and load it with its ``vbcs_tr_spmm`` typed."""
    out_dir = os.path.dirname(_lib.SO)
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"spmm_ab_{name}.so") for name, _, _ in named}
    if named:
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                        libs[name], src] for name, _, src in named])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    loaded = {}
    for name, kind, _ in named:
        fn = ctypes.CDLL(libs[name]).vbcs_tr_spmm
        fn.argtypes = ([i32, i64, i32, i32, i64, i32, i32, vp] if kind == "variant"
                       else [i32, i64]) + [vp] * 9
        fn.restype = i32
        loaded[name] = (kind, fn)
    return loaded


def _call(kind, fn, fmt, X):
    """A closure launching another build on ``fmt`` (a new Y each call);
    a variant is given the package's long stripes."""
    longs = fmt.long_stripes
    n_long = 0 if longs is None else longs.numel()

    def run():
        Y = torch.empty(fmt.n, X.shape[1], dtype=torch.float32, device=X.device)
        head = [fmt.L, X.shape[1]]
        if kind == "variant":
            head += [fmt.width_class, int(fmt.quad_widths), fmt.idx.numel(),
                     SPMM_LONG_BLOCKS, n_long, longs.data_ptr() if n_long else None]
        rc = fn(*head, fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.idx.data_ptr(),
                fmt.ofs.data_ptr(),
                None if fmt.col_out is None else fmt.col_out.data_ptr(),
                fmt.val.data_ptr(), X.data_ptr(), Y.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return Y
    return run


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1e-6, float(b.abs().max())))


def _shape(label, fmt, M, nnz, k, builds, dev) -> dict:
    rng = np.random.default_rng(16)
    X = torch.from_numpy(rng.standard_normal((fmt.m, k)).astype(np.float32)).to(dev)
    lib_M = csr(M, dev)
    cands = {"package": lambda: tr_spmm(fmt, X)}
    cands.update({n: _call(kind, fn, fmt, X)
                  for n, (kind, fn) in builds.items()})
    plain = tr_spmm_plain(fmt, X)
    library = lambda: lib_M @ X  # noqa: E731
    outs, errs = {}, {}
    for n, f in cands.items():
        a, b = f(), f()
        torch.cuda.synchronize()
        errs[n] = _rel(a, plain)
        if errs[n] > TOL or not torch.equal(a, b):
            raise RuntimeError(f"{label} {n}: off the plain version by {errs[n]:.2e}"
                               f" or two launches differ")
        outs[n] = a
    if _rel(library(), plain) > TOL:
        raise RuntimeError(f"{label}: the library call disagrees with the plain version")
    del plain
    same = {n: sorted(o for o in outs if o != n and torch.equal(outs[n], outs[o]))
            for n in outs}
    del outs
    fns = list(cands.values()) + [lambda: tr_spmm_plain(fmt, X), library]
    warm = paired_ms(fns, dev)
    big = 4 * k * (fmt.m + fmt.n) > L2_BYTES
    cold = ([flushed_ms(f, dev) for f in list(cands.values()) + [library]] if big
            else [None] * (len(cands) + 1))
    nbytes, flops = work(fmt, nnz, k)
    t_bytes, t_ops = nbytes / hbm_bandwidth(dev), flops / f32_flops(dev)
    bound_ms = max(t_bytes, t_ops) * 1e3
    widths = (fmt.spl[1:] - fmt.spl[:-1]).cpu().numpy()
    rec = {"shape": label, "k": k, "columns": fmt.n, "rows": fmt.m,
           "stripes": fmt.L, "blocks": fmt.idx.numel(), "nnz": nnz,
           "mean_width": float(widths.mean()) if widths.size else 0.0,
           "width_class": fmt.width_class, "quad_widths": fmt.quad_widths,
           "natural_view": fmt.col_out is not None,
           "mb_a_call": nbytes / 1e6, "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "plain_ms": warm[-2], "library_ms": warm[-1],
           "library_flushed_ms": cold[-1],
           "kernels": {n: {"ms": warm[i], "flushed_ms": cold[i], "rel_err": errs[n],
                           "bitwise": same[n]}
                       for i, n in enumerate(cands)}}

    def us(v):
        return "-" if v is None else f"{v * 1e3:.2f}"
    print(f"[{label} k={k}] {fmt.n} columns, {fmt.L} stripes (mean width "
          f"{rec['mean_width']:.3f}, class {fmt.width_class}), {fmt.idx.numel()} "
          f"blocks, {nbytes / 1e6:.1f} MB a call, bound {us(bound_ms)} us; " + "; ".join(
              f"{n} {us(v['ms'])} us warm ({bound_ms / v['ms']:.3f} of the bound), "
              f"{us(v['flushed_ms'])} flushed, bitwise {v['bitwise']}"
              for n, v in rec["kernels"].items())
          + f"; plain {us(warm[-2])} us; library (CSR @ X) {us(warm[-1])} us, "
          f"{us(cold[-1])} flushed", flush=True)
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
    ap.add_argument("--earlier", action="append",
                    help="NAME=SRC.cu, the interface without width, quads and "
                         "long stripes")
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmm_ab needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _lib.load()
    builds = _build(_named(args.variant, "variant") + _named(args.earlier, "earlier"))
    rec = {"card": smi, "shapes": []}
    for name in dict.fromkeys(op for _, op, _, _ in SHAPES):
        A, op, pack = operator(name, dev)
        nnz = int(np.count_nonzero(sp.csc_matrix(A).data))
        for label, _, d, k in (s for s in SHAPES if s[1] == name):
            M = A.T if d == "tr" else A
            rec["shapes"].append(_shape(label, pack(d), M, nnz, k, builds, dev))
        del op
        torch.cuda.empty_cache()
    print(smi)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
