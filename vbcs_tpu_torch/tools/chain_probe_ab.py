"""The chain probe kernel beside other builds of the same function.

Times the package's chain probe (``csrc/probe_chain.cu`` through
:func:`vbcs_tpu_torch.probes.probe_chain.chain`) beside each CUDA source
named on the command line, for each variant A-D on the probe's inputs (T
= 40): the marginal iteration of every build, the difference of
``N_LO`` = 20 and ``N_HI`` = 220 iterations, all builds' calls in one
``paired_ms`` set a variant.  Before timing, every build is held against
``chain_plain`` (``|Δ| / max|out| <= 2e-5``) and against the others
bitwise at ``n_iters`` = 1, 2, 3; each record says which builds' ``out``
it equals bitwise at all three.  Each source is compiled by ``nvcc`` into
a library of its own under ``build/`` (the package's ``csrc`` on the
include path, for ``barrier.cuh``).

    python -m vbcs_tpu_torch.tools.chain_probe_ab [--earlier NAME=SRC.cu ...]
        [--variant NAME=SRC.cu ...] [--json FILE]

An ``--earlier`` source exports the streaming kernel's interface
(``vbcs_probe_chain`` without a budget, ``vbcs_probe_chain_grid(variant,
*blocks)``) and is launched as its launcher did: every block the
occupancy API fits, at most one a 256 columns.  A ``--variant`` source
exports the package's interface and is launched at its own occupancy grid
and largest budget.  It needs a CUDA card and prints one line a variant,
the card's name and power limit, and a JSON record last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from ..ops import _lib
from ..probes import probe_chain as pc
from ..utils.timing import paired_ms
from .spmm_ab import _named, _rel

__all__ = ["ITERS", "variant_record", "main"]

TOL = 2e-5  # f32 sums in another order than the plain version's
ITERS = (1, 2, 3)  # chain lengths held bitwise and against the plain version


def _build(named: list[tuple[str, str, str]]) -> dict:
    """Compile each (name, interface, source) into
    ``build/chain_probe_ab_<name>.so`` (all at once) and load it with its
    two functions typed."""
    out_dir = os.path.dirname(_lib.SO)
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"chain_probe_ab_{name}.so")
            for name, _, _ in named}
    if named:
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", _lib.CSRC, "-shared",
                        "-o", libs[name], src] for name, _, src in named])
    vp, i32, u32, pi = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.POINTER(
        ctypes.c_int)
    loaded = {}
    for name, kind, _ in named:
        lib = ctypes.CDLL(libs[name])
        budget = [i32] if kind == "variant" else []
        lib.vbcs_probe_chain_grid.argtypes = [i32] + [pi] * (1 + len(budget))
        lib.vbcs_probe_chain_grid.restype = i32
        lib.vbcs_probe_chain.argtypes = [i32] * 4 + [vp] * 8 + [u32, i32] + budget + [vp]
        lib.vbcs_probe_chain.restype = i32
        loaded[name] = (kind, lib)
    return loaded


def _launcher(kind, lib, variant: str, inp: pc.ChainInputs):
    """``(run, blocks)``: ``run(n)`` launches another build's ``n``
    iterations on ``inp`` (a new ``out`` and new slots each call, as the
    package's launcher allocates them)."""
    X, code = inp.val.shape[1], pc._CODES[variant]
    n = ctypes.c_int(0)
    if kind == "earlier":
        rc = lib.vbcs_probe_chain_grid(code, ctypes.byref(n))
        blocks, extra = min(n.value, -(-X // 256)), []
    else:
        b = ctypes.c_int(-1)
        rc = lib.vbcs_probe_chain_grid(code, ctypes.byref(b), ctypes.byref(n))
        blocks, extra = n.value, [b.value]
    if rc != 0:
        raise RuntimeError(f"grid of {variant}: CUDA error {rc}")
    dev = inp.val.device
    count = torch.empty(1, dtype=torch.int32, device=dev)

    def run(n_iters):
        out = torch.empty(pc.W, X, dtype=torch.float32, device=dev)
        slots = torch.empty(2, 8, X, dtype=torch.float32, device=dev)
        rc = lib.vbcs_probe_chain(
            code, n_iters, X // pc.NS, inp.wblk, inp.val.data_ptr(),
            inp.meta.data_ptr(), inp.xin.data_ptr(), inp.wbase.data_ptr(),
            slots[0].data_ptr(), slots[1].data_ptr(), out.data_ptr(),
            count.data_ptr(), 0, blocks, *extra,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch of {variant} failed: CUDA error {rc}")
        return out
    return run, blocks


def variant_record(variant: str, wblk: int, blocks: dict, marginal_ms: dict,
                   rel_err: dict, bitwise: dict) -> dict:
    """One variant's record: for each build (``"package"`` first) its
    grid, marginal ms an iteration, error against the plain version and
    the builds whose ``out`` it equals bitwise at every ``ITERS``."""
    return {"variant": variant, "wblk": wblk, "T": pc.T,
            "n_lo": pc.N_LO, "n_hi": pc.N_HI,
            "builds": {n: {"blocks": blocks[n], "marginal_ms": marginal_ms[n],
                           "rel_err": rel_err[n], "bitwise": bitwise[n]}
                       for n in marginal_ms}}


def _variant(name: str, variant: str, wblk: int, builds: dict, dev) -> dict:
    inp = pc.inputs(pc.T, wblk).to(dev)
    fit, _ = pc.grid(dev, variant)
    runs, blocks = {"package": lambda n: pc.chain(variant, inp, n)}, {"package": fit}
    for n, (kind, lib) in builds.items():
        runs[n], blocks[n] = _launcher(kind, lib, variant, inp)
    errs = dict.fromkeys(runs, 0.0)
    outs = {n: [] for n in runs}
    for it in ITERS:
        plain = pc.chain_plain(variant, inp, it)
        for n, run in runs.items():
            got = run(it)
            torch.cuda.synchronize()
            e = _rel(got, plain)
            if e > TOL or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{variant} x{it} {n}: off the plain version by "
                                   f"{e:.2e}")
            errs[n] = max(errs[n], e)
            outs[n].append(got)
    same = {n: sorted(o for o in outs if o != n and all(
        torch.equal(a, b) for a, b in zip(outs[n], outs[o]))) for n in outs}
    del outs
    fns = [f for run in runs.values()
           for f in (lambda run=run: run(pc.N_LO), lambda run=run: run(pc.N_HI))]
    t = paired_ms(fns, dev, iters=5)
    marginal = {n: (t[2 * i + 1] - t[2 * i]) / (pc.N_HI - pc.N_LO)
                for i, n in enumerate(runs)}
    rec = variant_record(variant, wblk, blocks, marginal, errs, same)
    print(f"[{name}] " + "; ".join(
        f"{n} {v['marginal_ms'] * 1e3:.3f} us an iteration (grid {v['blocks']}, "
        f"|Δ|/max {v['rel_err']:.2e}, bitwise {v['bitwise']})"
        for n, v in rec["builds"].items()), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", action="append",
                    help="NAME=SRC.cu, the streaming kernel's interface (no budget)")
    ap.add_argument("--variant", action="append",
                    help="NAME=SRC.cu, the package's interface")
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args(argv)
    named = _named(args.earlier, "earlier") + _named(args.variant, "variant")
    if not torch.cuda.is_available():
        raise SystemExit("chain_probe_ab needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _lib.load()
    builds = _build(named)
    rec = {"card": smi, "variants": [_variant(name, var, wblk, builds, dev)
                                     for name, var, wblk in pc.VARIANTS]}
    print(smi)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
