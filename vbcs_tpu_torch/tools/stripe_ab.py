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

    python -m vbcs_tpu_torch.tools.stripe_ab [--variant NAME=SRC.cu ...]
        [--earlier NAME=SRC.cu ...] [--width W] [--json FILE]

A ``--variant`` source exports ``vbcs_tr_spmv`` with the package's
interface; an ``--earlier`` source the interface of the kernel the
package's replaced, which has no ``quads`` argument.  It needs a CUDA card and
prints one line a matrix, the card's name and power limit, and a JSON
record last.
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

from .. import VBCOperator
from ..ops import _lib
from ..ops.trspmv import tr_spmv, tr_spmv_plain
from ..utils.profile import f32_flops, hbm_bandwidth
from ..utils.timing import flushed_ms, paired_ms
from .matrices import BLOCKY_ABOVE_L2, blocky_matrix

__all__ = ["work", "main"]

TOL = 2e-5  # f32 sums in another order than the plain version's index_add_
ALPHA, BETA = 0.5, 0.25


def work(fmt, nnz: int) -> tuple[int, int]:
    """(bytes, flops) of ``y = alpha*A.T@x + beta*y`` on ``fmt``'s matrix
    with ``nnz`` nonzeros, as ``chip_smoke.tr_spmv_work`` counts them:
    each nonzero's value, the stripe splits, block pointers and block
    rows, x, y in and y out once; an FMA a nonzero and the scaling of
    each output."""
    index = sum(t.numel() * t.element_size() for t in (fmt.spl, fmt.pos, fmt.idx))
    return 4 * nnz + index + 4 * (fmt.m + 2 * fmt.n), 2 * nnz + 3 * fmt.n


def _build(named: list[tuple[str, str, str]]) -> dict:
    """Compile each (name, interface, source) into ``build/stripe_ab_<name>.so``
    (all at once) and load it with its ``vbcs_tr_spmv`` typed."""
    out_dir = os.path.dirname(_lib.SO)
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"stripe_ab_{name}.so") for name, _, _ in named}
    if named:
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                        libs[name], src] for name, _, src in named])
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    loaded = {}
    for name, kind, _ in named:
        lib = ctypes.CDLL(libs[name])
        fn = lib.vbcs_tr_spmv
        fn.argtypes = ([i32] * 3 if kind == "variant" else [i32]) + [vp] * 9 + [
            f32, f32, vp, vp]
        fn.restype = i32
        loaded[name] = (kind, fn)
    return loaded


def _call(kind, fn, fmt, xt, yt):
    """A closure launching another build on ``fmt`` (a new output each call)."""
    def run():
        out = torch.empty(fmt.n, dtype=torch.float32, device=xt.device)
        head = [fmt.n, fmt.L, int(fmt.quad_widths)] if kind == "variant" else [fmt.n]
        rc = fn(*head, fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.idx.data_ptr(),
                fmt.ofs.data_ptr(), fmt.col_stripe.data_ptr(), None,
                fmt.val.data_ptr(), xt.data_ptr(), yt.data_ptr(),
                ALPHA, BETA, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
    cands.update({k: _call(kind, fn, fmt, xt, yt) for k, (kind, fn) in builds.items()})
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
                    help="NAME=SRC.cu, the interface without quads")
    ap.add_argument("--width", type=int, default=8,
                    help="blocky_matrix's stripe width w (default 8, the flagship's)")
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
    builds = _build(_named(args.variant, "variant") + _named(args.earlier, "earlier"))
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
