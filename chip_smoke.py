"""End-to-end check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and g++:

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the CUDA kernels (``nvcc``, ``sm_90a``, one process per
   source) and the C++ host library, from the sources in the checkout
   into ``build/``;
3. every kernel against its plain PyTorch version on the card, the
   stripe TrSpMV and SpMM kernels also against the f64 host oracle, on
   the corpus, a multi-class DP plan, long multi-group stripes, a
   rectangular matrix: TrSpMV with and without alpha/beta/y, SpMM at
   k = 1, 5, 32, 128, 130; the gather on a masked random permutation
   (bitwise);
4. the main path at flagship scale: ``bench.blocky_matrix()`` (320,000
   columns, ~2.55M nonzeros) through ``VBCOperator.from_csc(A, W=8,
   device="cuda")``, ``tr_mul`` with alpha/beta/y and ``mul``, then
   ``tr_mul_mat`` at k=128 and ``mul_mat`` at k=32, checked against the
   host oracle and the f64 scipy product;
5. the auto-RCM path: the scrambled FEM ``bench.fem_matrix(k=320)``
   through ``from_csc(..., reorder="auto")``, the same calls (SpMM at
   k=32);
6. the scattered matrix ``bench.scattered_matrix()`` (82,654 columns,
   574k nonzeros: the regime that sends the JAX SpMM to its v1
   fallback), ``tr_mul_mat`` at k=32;
7. per-call device times from CUDA events, kernel beside plain version,
   and the operator's per-call time on the host clock.

Each path is driven between a reset and a read of the launch counts:
``tr_mul``/``mul`` of phases 4-5 (stripe TrSpMV and gather), then the
SpMM calls of phases 4-6 (SpMM kernel).  Then each kernel is held
against its plain version at the shapes those paths gave it: the stripe
kernel on both packs of both operators, the gather on the FEM operator's
permutation and its inverse (bitwise), the SpMM kernel on both packs of
all three operators with their RHS.  The next-to-last line is the
kernels' JSON record; the last line is the run's JSON result.  It
imports no JAX: the JAX package is the reference, not a dependency.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch import native
from vbcs_tpu_torch.ops import _lib
from vbcs_tpu_torch.utils.timing import flushed_ms, host_ms, paired_ms

from bench import blocky_matrix, fem_matrix, scattered_matrix

# |kernel - reference| / max|reference|: f32 sums in another order than
# the plain version (atomics) and the f64 oracle
TOL = 2e-5
SPMM_K = (1, 5, 32, 128, 130)  # scalar path, float4 path, two 128-col tiles
KERNELS = (vt.tr_spmv, vt.gather, vt.tr_spmm)
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max(initial=0.0)
                 / max(1e-6, np.abs(want).max(initial=0.0)))


def banded(m, n, d, band, seed):
    """d nonzeros per column within +-band rows of the diagonal."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-band, band, (n, d)), 0, m - 1)
    cols = np.repeat(np.arange(n), d)
    vals = rng.standard_normal(n * d).astype(np.float32)
    A = sp.coo_matrix((vals, (rows.reshape(-1), cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def long_stripes():
    """1600 dense rows in the first 8 columns: one stripe of 1600 blocks
    (many of the TPU kernel's 8-block groups, straddling its chunks)."""
    m = 2048
    rng = np.random.default_rng(7)
    dense = sp.coo_matrix(
        (rng.standard_normal(1600 * 8),
         (np.repeat(np.arange(1600), 8), np.tile(np.arange(8), 1600))),
        shape=(m, m))
    diag = sp.coo_matrix((np.ones(m - 8), (np.arange(8, m), np.arange(8, m))),
                         shape=(m, m))
    return (dense + diag).tocsc().astype(np.float32)


def corpus():
    z = np.load(os.path.join(ROOT, "data", "corpus.npz"))
    for key in sorted(k[: -len("__shape")] for k in z.files
                      if k.endswith("__shape")):
        A = sp.csc_matrix(
            (z[f"{key}__data"], z[f"{key}__indices"], z[f"{key}__indptr"]),
            shape=tuple(z[f"{key}__shape"]))
        yield key.replace("__", "/"), A.astype(np.float32)


def phase_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; "
              "the port's check needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device 0 = {torch.cuda.get_device_name(0)}"
          f" of {torch.cuda.device_count()}, nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    t_native = native.build()
    check(native.get_lib() is not None, "host native library did not load")
    t_kern, log = _lib.build()
    _lib.load()
    regs = " | ".join(line.split("ptxas info    : ")[-1] for line in log.splitlines()
                      if "registers" in line)
    print(f"[2 build] nvcc {' '.join(_lib.NVCC_FLAGS)} -> "
          f"{os.path.relpath(_lib.SO, ROOT)} in {t_kern:.2f} s ({regs}); "
          f"g++ host lib -> {os.path.relpath(native.SO, ROOT)} in "
          f"{t_native:.2f} s", flush=True)


def phase_kernels(dev, errs):
    rng = np.random.default_rng(0)
    cases = [(name, A, 8, None) for name, A in corpus()]
    cases += [
        ("multiclass_dp_w4", banded(500, 500, 5, 60, 12), 4,
         vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4)),
        ("long_multigroup_stripes", long_stripes(), 8, vt.EquiChunker(8)),
        ("rectangular_600x900", banded(600, 900, 5, 60, 17), 8, None),
    ]
    worst_plain = worst_oracle = spmm_plain = spmm_oracle = 0.0
    n_checks = n_spmm = 0
    for name, A, W, method in cases:
        B = vt.vbc1d(A, W, method)
        fmt = vt.VBC1DDevice.from_host(B, dev)
        m, n = A.shape
        if name == "multiclass_dp_w4":
            check(len(set(B.Phi.widths().tolist())) > 1, "DP plan has one class")
        x = rng.standard_normal(m).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        for alpha, beta, with_y in ((None, None, False), (0.5, 0.25, True)):
            got = vt.tr_spmv(fmt, xt, alpha, beta, yt if with_y else None)
            plain = vt.tr_spmv_plain(fmt, xt, alpha, beta, yt if with_y else None)
            torch.cuda.synchronize()
            got, plain = got.cpu().numpy(), plain.cpu().numpy()
            oracle = B.tr_mul(x.astype(np.float64),
                              1.0 if alpha is None else alpha,
                              beta if with_y else 0.0,
                              y.astype(np.float64) if with_y else None)
            e_p, e_o = rel_err(got, plain), rel_err(got, oracle)
            check(np.isfinite(got).all() and got.shape == (n,),
                  f"{name}: bad output")
            check(e_p <= TOL and e_o <= TOL,
                  f"{name}: kernel off by {e_p:.2e} (plain), {e_o:.2e} (oracle)")
            errs["tr_spmv"] = max(errs["tr_spmv"],
                                  float(np.abs(got - plain).max(initial=0.0)))
            worst_plain, worst_oracle = max(worst_plain, e_p), max(worst_oracle, e_o)
            n_checks += 1
        A64T = A.T.astype(np.float64)
        for k in SPMM_K:
            X = rng.standard_normal((m, k)).astype(np.float32)
            Xt = torch.from_numpy(X).to(dev)
            got = vt.tr_spmm(fmt, Xt)
            plain = vt.tr_spmm_plain(fmt, Xt)
            torch.cuda.synchronize()
            got, plain = got.cpu().numpy(), plain.cpu().numpy()
            e_p, e_o = rel_err(got, plain), rel_err(got, A64T @ X)
            check(np.isfinite(got).all() and got.shape == (n, k),
                  f"{name}: bad SpMM output at k={k}")
            check(e_p <= TOL and e_o <= TOL,
                  f"{name}: SpMM kernel at k={k} off by {e_p:.2e} (plain), "
                  f"{e_o:.2e} (oracle)")
            errs["tr_spmm"] = max(errs["tr_spmm"],
                                  float(np.abs(got - plain).max(initial=0.0)))
            spmm_plain, spmm_oracle = max(spmm_plain, e_p), max(spmm_oracle, e_o)
            n_spmm += 1

    n_g = 1 << 20
    g = torch.Generator(device=dev).manual_seed(1)
    src = torch.randn(n_g, device=dev, generator=g)
    perm = torch.randperm(n_g, device=dev, generator=g).to(torch.int32)
    mask = torch.rand(n_g, device=dev, generator=g) > 0.25
    for mk in (None, mask):
        got, plain = vt.gather(src, perm, mk), vt.gather_plain(src, perm, mk)
        check(torch.equal(got, plain), "gather differs from its plain version")
        errs["gather"] = max(errs["gather"], float((got - plain).abs().max()))
    print(f"[3 kernels] stripe TrSpMV: {n_checks} checks on {len(cases)} "
          f"matrices, worst |Δ|/max|y| {worst_plain:.3e} vs plain, "
          f"{worst_oracle:.3e} vs f64 oracle (tol {TOL}); SpMM: {n_spmm} "
          f"checks at k={SPMM_K}, worst |Δ|/max|Y| {spmm_plain:.3e} vs plain, "
          f"{spmm_oracle:.3e} vs f64 oracle; gather: "
          f"{n_g} elements, masked and unmasked, bitwise equal", flush=True)


def phase_flagship(dev):
    A = blocky_matrix()  # f32, 320,000 x 320,000
    C = vt.CSC.from_scipy(A)
    t0 = time.perf_counter()
    Phi = vt.pack_stripe(C, vt.default_1d_partitioner(8, 4))
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    vt.pack_1dvbc(C, Phi, 8)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = vt.VBCOperator.from_csc(A, W=8, device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    check(op.row_perm is None, "flagship unexpectedly relabeled")

    rng = np.random.default_rng(2)
    x = rng.standard_normal(op.m).astype(np.float32)
    y = rng.standard_normal(op.n).astype(np.float32)
    xf = rng.standard_normal(op.n).astype(np.float32)
    xt, yt, xft = (torch.from_numpy(a).to(dev) for a in (x, y, xf))
    got_tr = op.tr_mul(xt, 0.5, 0.25, yt)
    got_fw = op.mul(xft)
    torch.cuda.synchronize()
    got_tr, got_fw = got_tr.cpu().numpy(), got_fw.cpu().numpy()
    want_tr = op.host_tr.tr_mul(x.astype(np.float64), 0.5, 0.25,
                                y.astype(np.float64))
    want_fw = op.host_mul(xf.astype(np.float64))
    e_tr, e_fw = rel_err(got_tr, want_tr), rel_err(got_fw, want_fw)
    check(got_tr.shape == (op.n,) and np.isfinite(got_tr).all()
          and got_fw.shape == (op.m,) and np.isfinite(got_fw).all(),
          "flagship output has the wrong shape or non-finite values")
    check(e_tr <= TOL and e_fw <= TOL,
          f"flagship off the oracle: tr_mul {e_tr:.2e}, mul {e_fw:.2e}")
    B = op.host_tr
    print(f"[4 flagship] {op.m}x{op.n}, nnz {A.nnz}, {B.L} stripes, "
          f"{B.num_blocks} blocks, {B.val.size} stored values; plan "
          f"{t_plan:.3f} s, pack {t_pack:.3f} s, from_csc (both directions, "
          f"to device) {t_op:.3f} s; tr_mul(alpha, beta, y) |Δ|/max {e_tr:.3e},"
          f" mul {e_fw:.3e} vs f64 oracle", flush=True)
    return A, op, xt, yt


def phase_fem(dev):
    A = fem_matrix(k=320).astype(np.float32)
    t0 = time.perf_counter()
    op = vt.VBCOperator.from_csc(A, W=8, reorder="auto", device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    check(op.row_perm is not None, "auto-RCM did not relabel the scrambled FEM")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(op.m).astype(np.float32)
    y = rng.standard_normal(op.n).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    got_tr = op.tr_mul(xt, 2.0, -0.5, yt)
    got_fw = op.mul(xt)
    torch.cuda.synchronize()
    A64 = A.astype(np.float64)
    e_tr = rel_err(got_tr.cpu().numpy(),
                   2.0 * (A64.T @ x) - 0.5 * y.astype(np.float64))
    e_fw = rel_err(got_fw.cpu().numpy(), A64 @ x)
    check(e_tr <= TOL and e_fw <= TOL,
          f"FEM off the f64 product: tr_mul {e_tr:.2e}, mul {e_fw:.2e}")
    widths = np.bincount(op.host_tr.Phi.widths())
    print(f"[5 fem auto-RCM] {op.m}x{op.n}, nnz {A.nnz}, relabeled by RCM, "
          f"stripe widths {dict((w, int(c)) for w, c in enumerate(widths) if c)}; "
          f"from_csc {t_op:.3f} s; tr_mul(alpha, beta, y) |Δ|/max {e_tr:.3e}, "
          f"mul {e_fw:.3e} vs f64 product", flush=True)
    return A, op, xt, yt


def spmm_run(label, A, op, k_tr, k_fw, rng, dev, note=""):
    """``op.tr_mul_mat`` at ``k_tr`` (and ``op.mul_mat`` at ``k_fw``)
    against the f64 scipy products; returns the operator and the RHS on
    the card."""
    X = rng.standard_normal((op.m, k_tr)).astype(np.float32)
    Xt = torch.from_numpy(X).to(dev)
    Xf = Xft = None
    got_tr = op.tr_mul_mat(Xt)
    if k_fw is not None:
        Xf = rng.standard_normal((op.n, k_fw)).astype(np.float32)
        Xft = torch.from_numpy(Xf).to(dev)
        got_fw = op.mul_mat(Xft)
    torch.cuda.synchronize()
    A64 = A.astype(np.float64)
    got_tr = got_tr.cpu().numpy()
    check(got_tr.shape == (op.n, k_tr) and np.isfinite(got_tr).all(),
          f"{label}: tr_mul_mat output has the wrong shape or non-finite values")
    e_tr = rel_err(got_tr, A64.T @ X)
    msg = f"tr_mul_mat k={k_tr} |Δ|/max {e_tr:.3e}"
    e_fw = 0.0
    if k_fw is not None:
        got_fw = got_fw.cpu().numpy()
        check(got_fw.shape == (op.m, k_fw) and np.isfinite(got_fw).all(),
              f"{label}: mul_mat output has the wrong shape or non-finite values")
        e_fw = rel_err(got_fw, A64 @ Xf)
        msg += f", mul_mat k={k_fw} {e_fw:.3e}"
    check(e_tr <= TOL and e_fw <= TOL, f"{label} SpMM off the f64 product: {msg}")
    print(f"[{label} SpMM] {op.m}x{op.n}{note}; {msg} vs f64 scipy product",
          flush=True)
    return op, Xt, Xft


def phase_spmm(dev, flag, fem):
    """The SpMM path: ``tr_mul_mat``/``mul_mat`` on the operators of
    phases 4-5, then the scattered matrix through its own operator."""
    rng = np.random.default_rng(6)
    runs = {
        "flagship": spmm_run("4 flagship", flag[0], flag[1], 128, 32, rng, dev),
        "FEM": spmm_run("5 fem auto-RCM", fem[0], fem[1], 32, 32, rng, dev),
    }
    A = scattered_matrix().astype(np.float32)
    t0 = time.perf_counter()
    op = vt.VBCOperator.from_csc(A, W=8, device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    widths = np.bincount(op.host_tr.Phi.widths())
    order = "natural order" if op.row_perm is None else "relabeled by RCM"
    note = (f", nnz {A.nnz}, {order}, {op.host_tr.num_blocks} blocks, stripe widths "
            f"{dict((w, int(c)) for w, c in enumerate(widths) if c)}; "
            f"from_csc {t_op:.3f} s")
    runs["scattered"] = spmm_run("6 scattered", A, op, 32, None, rng, dev, note)
    return runs


def phase_path_shapes(flag, fem, spmm, errs):
    """Each kernel against its plain version on the formats, permutations,
    vectors and RHS of phases 4-6 (after the launch counts are read)."""
    worst = 0.0
    for label, (_, op, xt, yt) in (("flagship", flag), ("FEM", fem)):
        for direction, fmt in (("tr_mul", op.dev_tr), ("mul", op.dev_fw)):
            for args in ((None, None, None), (0.5, 0.25, yt)):
                got = vt.tr_spmv(fmt, xt, *args)
                plain = vt.tr_spmv_plain(fmt, xt, *args)
                e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
                check(e <= TOL, f"{label} {direction} pack: kernel off its "
                                f"plain version by {e:.2e}")
                worst = max(worst, e)
                errs["tr_spmv"] = max(errs["tr_spmv"],
                                      float((got - plain).abs().max()))
    _, op2, xt2, yt2 = fem
    for name, src, perm in (("perm", xt2, op2.perm_t), ("inverse", yt2, op2.inv_t)):
        got, plain = vt.gather(src, perm), vt.gather_plain(src, perm)
        check(torch.equal(got, plain),
              f"gather of the FEM {name} permutation differs from its plain version")
        errs["gather"] = max(errs["gather"], float((got - plain).abs().max()))
    print(f"[4-5 kernels at the path's shapes] stripe TrSpMV on the flagship "
          f"and FEM packs, both directions, with and without alpha/beta/y: "
          f"worst |Δ|/max|y| {worst:.3e} vs plain (tol {TOL}); gather of the "
          f"FEM perm (x) and inverse (y): bitwise equal", flush=True)

    worst = 0.0
    for label, (op, Xt, Xft) in spmm.items():
        for direction, fmt, X in (("tr_mul_mat", op.dev_tr, Xt),
                                  ("mul_mat", op.dev_fw, Xft)):
            if X is None:
                continue
            got, plain = vt.tr_spmm(fmt, X), vt.tr_spmm_plain(fmt, X)
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"{label} {direction} pack: SpMM kernel off its "
                            f"plain version by {e:.2e}")
            worst = max(worst, e)
            errs["tr_spmm"] = max(errs["tr_spmm"], float((got - plain).abs().max()))
    print(f"[4-6 SpMM at the path's shapes] SpMM kernel on the flagship, FEM "
          f"and scattered packs with their RHS: worst |Δ|/max|Y| {worst:.3e} "
          f"vs plain (tol {TOL})", flush=True)


def phase_timing(dev, flag, fem, spmm):
    A, op, xt, yt = flag
    fmt = op.dev_tr
    k_ms, p_ms = paired_ms(
        [lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt),
         lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt)], dev)
    cold_ms = flushed_ms(lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt), dev)
    cold_plain = flushed_ms(lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt), dev)
    nbytes = fmt.nbytes + 4 * (fmt.m + 2 * fmt.n)  # + x, y in, y out
    print(f"[7 timing tr_spmv, flagship] kernel {k_ms * 1e3:.2f} us/call "
          f"(back-to-back, L2-warm: {nbytes / 1e6:.1f} MB per call), "
          f"{cold_ms * 1e3:.2f} us with L2 flushed; plain {p_ms * 1e3:.2f} us, "
          f"{cold_plain * 1e3:.2f} us flushed; "
          f"{nbytes / (k_ms * 1e6):.1f} GB/s warm, "
          f"{nbytes / (cold_ms * 1e6):.1f} GB/s flushed, "
          f"{A.nnz / (k_ms * 1e6):.2f} Gnnz/s warm", flush=True)

    A2, op2, xt2, yt2 = fem
    g_ms, gp_ms = paired_ms([lambda: vt.gather(xt2, op2.perm_t),
                             lambda: vt.gather_plain(xt2, op2.perm_t)], dev)
    e2e_fem, e2e_flag = paired_ms(
        [lambda: op2.tr_mul(xt2, 2.0, -0.5, yt2),
         lambda: op.tr_mul(xt, 0.5, 0.25, yt)], dev)
    wall_flag = host_ms(lambda: op.tr_mul(xt, 0.5, 0.25, yt), dev)
    wall_fem = host_ms(lambda: op2.tr_mul(xt2, 2.0, -0.5, yt2), dev)
    print(f"[7 timing gather, FEM perm of {op2.m}] kernel {g_ms * 1e3:.2f} "
          f"us/call, plain {gp_ms * 1e3:.2f} us; end-to-end tr_mul(alpha, "
          f"beta, y), device / host wall per call: flagship "
          f"{e2e_flag * 1e3:.2f} / {wall_flag * 1e3:.2f} us, FEM auto-RCM "
          f"{e2e_fem * 1e3:.2f} / {wall_fem * 1e3:.2f} us", flush=True)

    spmm_ms = {}
    for label in ("flagship", "scattered"):
        op_s, Xt, _ = spmm[label]
        fmt, k = op_s.dev_tr, Xt.shape[1]
        s_ms, sp_ms = paired_ms([lambda: vt.tr_spmm(fmt, Xt),
                                 lambda: vt.tr_spmm_plain(fmt, Xt)], dev)
        # the X rows the blocks read and the Y written, beside the format
        nbytes = fmt.nbytes + 4 * k * (fmt.idx.numel() + fmt.n)
        nnz = int(np.count_nonzero(op_s.host_tr.val))
        print(f"[7 timing tr_spmm, {label} k={k}] kernel {s_ms * 1e3:.2f} us/call,"
              f" plain {sp_ms * 1e3:.2f} us; {nbytes / 1e6:.1f} MB per call, "
              f"{nbytes / (s_ms * 1e6):.1f} GB/s effective, "
              f"{nnz * k / (s_ms * 1e6):.2f} Gnnz*k/s", flush=True)
        spmm_ms[label] = (s_ms, sp_ms)
    op_f, Xt, _ = spmm["flagship"]
    e2e_mat = paired_ms([lambda: op_f.tr_mul_mat(Xt)], dev)[0]
    wall_mat = host_ms(lambda: op_f.tr_mul_mat(Xt), dev)
    print(f"[7 timing tr_mul_mat, flagship k={Xt.shape[1]}] end to end, device "
          f"/ host wall per call: {e2e_mat * 1e3:.2f} / {wall_mat * 1e3:.2f} us",
          flush=True)
    return {"tr_spmv": (k_ms, p_ms), "gather": (g_ms, gp_ms),
            "tr_spmm": spmm_ms["flagship"]}


def reset_launches():
    for kern in KERNELS:
        kern.launches = 0


def main():
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    errs = {"tr_spmv": 0.0, "gather": 0.0, "tr_spmm": 0.0}
    phase_kernels(dev, errs)

    reset_launches()
    flag = phase_flagship(dev)
    fem = phase_fem(dev)
    launches = {"tr_spmv": vt.tr_spmv.launches, "gather": vt.gather.launches}
    check(launches["tr_spmv"] > 0 and launches["gather"] > 0,
          f"tr_mul/mul path skipped a kernel: {launches}")
    print(f"[4-5 launches] tr_mul/mul path: stripe TrSpMV {launches['tr_spmv']}, "
          f"gather {launches['gather']}", flush=True)

    reset_launches()
    spmm = phase_spmm(dev, flag, fem)
    launches["tr_spmm"] = vt.tr_spmm.launches
    check(launches["tr_spmm"] > 0, "tr_mul_mat/mul_mat path skipped the SpMM kernel")
    print(f"[4-6 launches] tr_mul_mat/mul_mat path: SpMM {launches['tr_spmm']}",
          flush=True)

    phase_path_shapes(flag, fem, spmm, errs)
    ms = phase_timing(dev, flag, fem, spmm)
    check("jax" not in sys.modules, "the port loaded JAX")
    rec = [
        {"name": "tr_spmv_stripe", "route": "cuda",
         "source": "vbcs_tpu_torch/csrc/trspmv.cu",
         "replaces": "vbcs_tpu/ops/pallas_trspmv3.py:1145",
         "launches": launches["tr_spmv"], "max_abs_err": errs["tr_spmv"],
         "ms": ms["tr_spmv"][0], "plain_ms": ms["tr_spmv"][1]},
        {"name": "gather", "route": "cuda",
         "source": "vbcs_tpu_torch/csrc/gather.cu",
         "replaces": "vbcs_tpu/ops/windowed_gather.py:184",
         "launches": launches["gather"], "max_abs_err": errs["gather"],
         "ms": ms["gather"][0], "plain_ms": ms["gather"][1]},
        {"name": "tr_spmm", "route": "cuda",
         "source": "vbcs_tpu_torch/csrc/spmm.cu",
         "replaces": "vbcs_tpu/ops/pallas_spmm4.py:209, "
                     "vbcs_tpu/ops/pallas_spmm3.py:42, "
                     "vbcs_tpu/ops/pallas_spmm.py:33, "
                     "vbcs_tpu/ops/pallas_trspmv.py:215",
         "launches": launches["tr_spmm"], "max_abs_err": errs["tr_spmm"],
         "ms": ms["tr_spmm"][0], "plain_ms": ms["tr_spmm"][1]},
    ]
    print(smi)
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
