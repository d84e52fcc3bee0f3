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
   TrSpMV and SpMM kernels also against the f64 host oracle: the stripe
   TrSpMV and SpMM on the corpus, a multi-class DP plan, long multi-group
   stripes, a rectangular matrix (TrSpMV with and without alpha/beta/y,
   SpMM at k = 1, 5, 32, 128, 130); the 2-D tile TrSpMV, with and without
   alpha/beta/y, on the corpus under ``vbc2d(A, 4, 4)``, an explicit
   mixed-height row partition, a tile straddling an aligned 1024-row
   boundary, a 600 x 900 rectangle and a U=W=8 default plan; the gather
   on a masked random permutation (bitwise);
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
7. the 2-D operator at full width, ``VBC2DOperator.from_csc``: (a)
   ``bench.blocky2d_matrix()`` (40,000 x 80,000) under the JAX bench's
   equi plan (U=4, W=8), (b) the flagship under the default five-pass
   planner at U=W=8 (mixed tile heights); ``tr_mul`` with alpha/beta/y
   and ``mul`` against the f64 oracle and the scipy product,
   ``tr_mul_mat`` at k=128 and ``mul_mat`` at k=32;
8. per-call device times from CUDA events, kernel beside plain version
   (the tile kernel also beside the stripe kernel on the same matrix's
   1-D view), and the operators' per-call time on the host clock.

Each path is driven between a reset and a read of the launch counts:
``tr_mul``/``mul`` of phases 4-5 (stripe TrSpMV and gather), the SpMM
calls of phases 4-6 (SpMM kernel), then the 2-D calls of phase 7 (tile
TrSpMV, and the SpMM kernel on the 1-D views).  Then each kernel is held
against its plain version at the shapes those paths gave it: the stripe
kernel on both packs of both operators, the gather on the FEM operator's
permutation and its inverse (bitwise), the SpMM kernel on both packs of
all five operators with their RHS, the tile kernel on the four 2-D packs.
The next-to-last line is the kernels' JSON record; the last line is the
run's JSON result.  It imports no JAX: the JAX package is the reference,
not a dependency.
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

from bench import blocky2d_matrix, blocky_matrix, fem_matrix, scattered_matrix

# |kernel - reference| / max|reference|: f32 sums in another order than
# the plain version (atomics) and the f64 oracle
TOL = 2e-5
SPMM_K = (1, 5, 32, 128, 130)  # scalar path, float4 path, two 128-col tiles
KERNELS = (vt.tr_spmv, vt.gather, vt.tr_spmm, vt.tr_spmv_2d)
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


def mixed_height_pack():
    """A banded 300 x 160 matrix under an explicit row partition of
    alternating heights 1 and 3, stripes of width 4: stripes mix tiles of
    both heights (the JAX route sends those to its 1-D stream kernel)."""
    A = banded(300, 160, 6, 40, 4)
    Pi = vt.SplitPartition(np.concatenate([[0], np.cumsum(np.tile([1, 3], 75))]))
    return vt.pack_vbc2d(vt.CSC.from_scipy(A), Pi, vt.SplitPartition.equi(160, 4),
                         3, 4)


def straddle_pack():
    """Two 4 x 4 tiles under a row partition offset by 2: the one at rows
    1022-1025 crosses an aligned 1024-row boundary (the TPU kernel's
    x-window edge)."""
    dense = np.zeros((2048, 8), np.float32)
    rng = np.random.default_rng(5)
    dense[1022:1026, 0:4] = rng.standard_normal((4, 4))
    dense[98:102, 4:8] = rng.standard_normal((4, 4))
    Pi = vt.SplitPartition(np.concatenate([[0], np.arange(2, 2048, 4), [2048]]))
    return vt.pack_vbc2d(vt.CSC.from_scipy(sp.csc_matrix(dense)), Pi,
                         vt.SplitPartition(np.array([0, 4, 8])), 4, 4)


def mixed_stripes(B2) -> int:
    """How many stripes of a 2-D pack hold tiles of more than one height."""
    u = B2.Pi.widths()[B2.idx]
    starts = B2.pos[:-1][np.diff(B2.pos) > 0]
    if not starts.size:
        return 0
    return int((np.minimum.reduceat(u, starts)
                != np.maximum.reduceat(u, starts)).sum())


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


def check_tr(name, kernel, plain, host, fmt, rng, dev, errs):
    """``kernel`` against ``plain`` and the f64 host oracle on one pack,
    without and with alpha/beta/y; returns the worst relative errors
    (vs plain, vs oracle)."""
    m, n = host.shape
    x = rng.standard_normal(m).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    worst = [0.0, 0.0]
    for alpha, beta, with_y in ((None, None, False), (0.5, 0.25, True)):
        got = kernel(fmt, xt, alpha, beta, yt if with_y else None)
        ref = plain(fmt, xt, alpha, beta, yt if with_y else None)
        torch.cuda.synchronize()
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        oracle = host.tr_mul(x.astype(np.float64),
                             1.0 if alpha is None else alpha,
                             beta if with_y else 0.0,
                             y.astype(np.float64) if with_y else None)
        e_p, e_o = rel_err(got, ref), rel_err(got, oracle)
        check(np.isfinite(got).all() and got.shape == (n,), f"{name}: bad output")
        check(e_p <= TOL and e_o <= TOL,
              f"{name}: kernel off by {e_p:.2e} (plain), {e_o:.2e} (oracle)")
        key = kernel.__name__
        errs[key] = max(errs[key], float(np.abs(got - ref).max(initial=0.0)))
        worst = [max(worst[0], e_p), max(worst[1], e_o)]
    return worst


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
        e_p, e_o = check_tr(name, vt.tr_spmv, vt.tr_spmv_plain, B, fmt, rng,
                            dev, errs)
        worst_plain, worst_oracle = max(worst_plain, e_p), max(worst_oracle, e_o)
        n_checks += 2
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

    mixed = mixed_height_pack()
    check(mixed_stripes(mixed) > 0, "mixed_heights pack is uniform")
    tile_cases = [(f"{name} vbc2d(4, 4)", vt.vbc2d(A, 4, 4)) for name, A in corpus()]
    tile_cases += [
        ("mixed_heights", mixed),
        ("straddling_tile", straddle_pack()),
        ("rectangular_600x900", vt.vbc2d(banded(600, 900, 5, 60, 17), 4, 8)),
        ("default_u8w8", vt.vbc2d(blocky_matrix(L=2048), 8, 8)),
    ]
    tile_worst = [0.0, 0.0]
    for name, B2 in tile_cases:
        e = check_tr(name, vt.tr_spmv_2d, vt.tr_spmv_2d_plain, B2,
                     vt.VBC2DDevice.from_host(B2, dev), rng, dev, errs)
        tile_worst = [max(a, b) for a, b in zip(tile_worst, e)]

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
          f"{spmm_oracle:.3e} vs f64 oracle; tile TrSpMV: "
          f"{2 * len(tile_cases)} checks on {len(tile_cases)} 2-D packs, worst "
          f"{tile_worst[0]:.3e} vs plain, {tile_worst[1]:.3e} vs f64 oracle; "
          f"gather: {n_g} elements, masked and unmasked, bitwise equal",
          flush=True)


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


def phase_2d(dev):
    """The 2-D operator at full width: (a) ``blocky2d_matrix()`` under the
    JAX bench's equi plan, (b) the flagship under the default five-pass
    planner; ``tr_mul``/``mul``/``tr_mul_mat``/``mul_mat`` against the f64
    oracle and the scipy products.  Returns, per part, the matrix, the
    operator and its vectors and RHS on the card."""
    equi = (vt.AlternatingPacker(vt.EquiChunker(8), vt.EquiChunker(4)),
            vt.AlternatingPacker(vt.EquiChunker(4), vt.EquiChunker(8)))
    specs = (("a", "blocky2d equi", blocky2d_matrix(), 4, 8, equi),
             ("b", "flagship default", blocky_matrix(), 8, 8, (None, None)))
    rng = np.random.default_rng(7)
    parts = {}
    for part, label, A, U, W, (method, method_fw) in specs:
        C = vt.CSC.from_scipy(A)
        t0 = time.perf_counter()
        Pi, Phi = vt.pack_plaid(C, method or vt.default_2d_partitioner(U, W, 4))
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        vt.pack_vbc2d(C, Pi, Phi, U, W)
        t_pack = time.perf_counter() - t0
        launched = vt.tr_spmv_2d.launches
        t0 = time.perf_counter()
        op = vt.VBC2DOperator.from_csc(A, U, W, method, method_fw, device=dev)
        torch.cuda.synchronize()
        t_op = time.perf_counter() - t0
        B = op.host_tr
        mixed = mixed_stripes(B)
        check(part != "b" or mixed > 0,
              "the flagship's default 2-D plan has no mixed-height stripes")

        x = rng.standard_normal(op.m).astype(np.float32)
        y = rng.standard_normal(op.n).astype(np.float32)
        xf = rng.standard_normal(op.n).astype(np.float32)
        X = rng.standard_normal((op.m, 128)).astype(np.float32)
        Xf = rng.standard_normal((op.n, 32)).astype(np.float32)
        xt, yt, xft, Xt, Xft = (torch.from_numpy(a).to(dev)
                                for a in (x, y, xf, X, Xf))
        got = {"tr_mul": op.tr_mul(xt, 0.5, 0.25, yt), "mul": op.mul(xft),
               "tr_mul_mat": op.tr_mul_mat(Xt), "mul_mat": op.mul_mat(Xft)}
        torch.cuda.synchronize()
        got = {k: t.cpu().numpy() for k, t in got.items()}
        tiles = vt.tr_spmv_2d.launches - launched
        check(tiles > 0, f"2-D part ({part}) did not launch the tile kernel")
        A64 = A.astype(np.float64)
        want = {
            "tr_mul": (0.5 * (A64.T @ x) + 0.25 * y.astype(np.float64),
                       B.tr_mul(x.astype(np.float64), 0.5, 0.25,
                                y.astype(np.float64))),
            "mul": (A64 @ xf, op.host_mul(xf.astype(np.float64))),
            "tr_mul_mat": (A64.T @ X, None),
            "mul_mat": (A64 @ Xf, None),
        }
        errs = {}
        for call, (scipy_ref, oracle) in want.items():
            check(got[call].shape == scipy_ref.shape
                  and np.isfinite(got[call]).all(),
                  f"2-D ({part}) {call}: wrong shape or non-finite values")
            errs[call] = max(rel_err(got[call], scipy_ref),
                             0.0 if oracle is None else rel_err(got[call], oracle))
            check(errs[call] <= TOL,
                  f"2-D ({part}) {call} off the f64 references by {errs[call]:.2e}")
        print(f"[7 2-D ({part}) {label}] {op.m}x{op.n}, nnz {A.nnz}, U={U} W={W}: "
              f"K={B.K} row blocks (heights {B.Pi.widths().min()}-"
              f"{B.Pi.widths().max()}), L={B.L} stripes, {B.num_blocks} tiles, "
              f"{B.val.size} stored values, {mixed} mixed-height stripes; plan "
              f"{t_plan:.3f} s, pack {t_pack:.3f} s, from_csc (both directions, "
              f"to device) {t_op:.3f} s; tile launches {tiles}; |Δ|/max vs f64 "
              f"oracle and scipy: tr_mul(alpha, beta, y) {errs['tr_mul']:.3e}, "
              f"mul {errs['mul']:.3e}, tr_mul_mat k=128 "
              f"{errs['tr_mul_mat']:.3e}, mul_mat k=32 {errs['mul_mat']:.3e}",
              flush=True)
        parts[part] = (A, op, xt, yt, xft, Xt, Xft)
    return parts


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


def phase_path_shapes_2d(parts, errs):
    """The tile kernel on the four 2-D packs of phase 7 (both directions of
    both parts), with and without alpha/beta/y, and the SpMM kernel on
    their 1-D views with the phase's RHS, each against its plain version."""
    worst = worst_mm = 0.0
    for part, (_, op, xt, yt, xft, Xt, Xft) in parts.items():
        for fmt, x, y in ((op.dev_tr, xt, yt), (op.dev_fw, xft, xt)):
            for args in ((None, None, None), (0.5, 0.25, y)):
                got = vt.tr_spmv_2d(fmt, x, *args)
                plain = vt.tr_spmv_2d_plain(fmt, x, *args)
                e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
                check(e <= TOL, f"2-D ({part}) pack: tile kernel off its plain "
                                f"version by {e:.2e}")
                worst = max(worst, e)
                errs["tr_spmv_2d"] = max(errs["tr_spmv_2d"],
                                         float((got - plain).abs().max()))
        for view, X in ((op.view_tr, Xt), (op.view_fw, Xft)):
            got, plain = vt.tr_spmm(view, X), vt.tr_spmm_plain(view, X)
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"2-D ({part}) 1-D view: SpMM kernel off its plain "
                            f"version by {e:.2e}")
            worst_mm = max(worst_mm, e)
            errs["tr_spmm"] = max(errs["tr_spmm"], float((got - plain).abs().max()))
    print(f"[7 kernels at the path's shapes] tile TrSpMV on the four 2-D packs, "
          f"with and without alpha/beta/y: worst |Δ|/max|y| {worst:.3e} vs plain; "
          f"SpMM on their 1-D views: {worst_mm:.3e} vs plain (tol {TOL})",
          flush=True)


def phase_timing_2d(dev, parts):
    """Part (a): the tile kernel, its plain version and the stripe kernel
    on the same matrix's 1-D view, warm and L2-flushed; end to end
    ``tr_mul`` and ``tr_mul_mat``.  Part (b): tile against stripe on the
    1-D view, warm and flushed (the mixed-height plan)."""
    out = {}
    for part, (A, op, xt, yt, _, Xt, _) in parts.items():
        fmt, view = op.dev_tr, op.view_tr
        calls = [lambda: vt.tr_spmv_2d(fmt, xt, 0.5, 0.25, yt),
                 lambda: vt.tr_spmv(view, xt, 0.5, 0.25, yt)]
        if part == "a":
            calls.append(lambda: vt.tr_spmv_2d_plain(fmt, xt, 0.5, 0.25, yt))
        warm = paired_ms(calls, dev)
        cold = [flushed_ms(c, dev) for c in calls]
        io = 4 * (fmt.m + 2 * fmt.n)  # x, y in, y out
        stored, nnz = fmt.val.numel(), A.nnz
        line = (f"[8 timing 2-D ({part}), {stored} stored values, {nnz} nnz] "
                f"tile kernel {warm[0] * 1e3:.2f} us/call warm, "
                f"{cold[0] * 1e3:.2f} us flushed ({(fmt.nbytes + io) / 1e6:.2f} MB "
                f"per call: {(fmt.nbytes + io) / (warm[0] * 1e6):.1f} GB/s warm, "
                f"{(fmt.nbytes + io) / (cold[0] * 1e6):.1f} flushed; "
                f"{stored / (warm[0] * 1e6):.2f} Gstored/s, "
                f"{nnz / (warm[0] * 1e6):.2f} Gnnz/s warm); stripe kernel on the "
                f"1-D view {warm[1] * 1e3:.2f} us warm, {cold[1] * 1e3:.2f} us "
                f"flushed ({(view.nbytes + io) / 1e6:.2f} MB per call: "
                f"{(view.nbytes + io) / (warm[1] * 1e6):.1f} GB/s warm; "
                f"{stored / (warm[1] * 1e6):.2f} Gstored/s, "
                f"{nnz / (warm[1] * 1e6):.2f} Gnnz/s warm)")
        if part == "a":
            line += (f"; plain {warm[2] * 1e3:.2f} us warm, "
                     f"{cold[2] * 1e3:.2f} us flushed")
            e2e, e2e_mat = paired_ms([lambda: op.tr_mul(xt, 0.5, 0.25, yt),
                                      lambda: op.tr_mul_mat(Xt)], dev)
            wall = host_ms(lambda: op.tr_mul(xt, 0.5, 0.25, yt), dev)
            wall_mat = host_ms(lambda: op.tr_mul_mat(Xt), dev)
            line += (f"; end to end, device / host wall per call: tr_mul(alpha, "
                     f"beta, y) {e2e * 1e3:.2f} / {wall * 1e3:.2f} us, tr_mul_mat "
                     f"k=128 {e2e_mat * 1e3:.2f} / {wall_mat * 1e3:.2f} us")
            out = {"tr_spmv_2d": (warm[0], warm[2])}
        print(line, flush=True)
    return out


def phase_timing(dev, flag, fem, spmm):
    A, op, xt, yt = flag
    fmt = op.dev_tr
    k_ms, p_ms = paired_ms(
        [lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt),
         lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt)], dev)
    cold_ms = flushed_ms(lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt), dev)
    cold_plain = flushed_ms(lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt), dev)
    nbytes = fmt.nbytes + 4 * (fmt.m + 2 * fmt.n)  # + x, y in, y out
    print(f"[8 timing tr_spmv, flagship] kernel {k_ms * 1e3:.2f} us/call "
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
    print(f"[8 timing gather, FEM perm of {op2.m}] kernel {g_ms * 1e3:.2f} "
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
        print(f"[8 timing tr_spmm, {label} k={k}] kernel {s_ms * 1e3:.2f} us/call,"
              f" plain {sp_ms * 1e3:.2f} us; {nbytes / 1e6:.1f} MB per call, "
              f"{nbytes / (s_ms * 1e6):.1f} GB/s effective, "
              f"{nnz * k / (s_ms * 1e6):.2f} Gnnz*k/s", flush=True)
        spmm_ms[label] = (s_ms, sp_ms)
    op_f, Xt, _ = spmm["flagship"]
    e2e_mat = paired_ms([lambda: op_f.tr_mul_mat(Xt)], dev)[0]
    wall_mat = host_ms(lambda: op_f.tr_mul_mat(Xt), dev)
    print(f"[8 timing tr_mul_mat, flagship k={Xt.shape[1]}] end to end, device "
          f"/ host wall per call: {e2e_mat * 1e3:.2f} / {wall_mat * 1e3:.2f} us",
          flush=True)
    return {"tr_spmv": (k_ms, p_ms), "gather": (g_ms, gp_ms),
            "tr_spmm": spmm_ms["flagship"]}


def reset_launches():
    for kern in KERNELS:
        kern.launches = 0


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    errs = {"tr_spmv": 0.0, "gather": 0.0, "tr_spmm": 0.0, "tr_spmv_2d": 0.0}
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

    reset_launches()
    parts = phase_2d(dev)
    launches["tr_spmv_2d"] = vt.tr_spmv_2d.launches
    spmm_2d = vt.tr_spmm.launches
    check(launches["tr_spmv_2d"] > 0 and spmm_2d > 0 and vt.tr_spmv.launches == 0,
          f"2-D path: tile TrSpMV {launches['tr_spmv_2d']}, SpMM {spmm_2d}, "
          f"stripe TrSpMV {vt.tr_spmv.launches} launches")
    print(f"[7 launches] 2-D path: tile TrSpMV {launches['tr_spmv_2d']}, "
          f"SpMM on the 1-D views {spmm_2d}", flush=True)

    phase_path_shapes(flag, fem, spmm, errs)
    phase_path_shapes_2d(parts, errs)
    ms = phase_timing(dev, flag, fem, spmm)
    ms.update(phase_timing_2d(dev, parts))
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
        {"name": "tr_spmv_2d", "route": "cuda",
         "source": "vbcs_tpu_torch/csrc/trspmv2d.cu",
         "replaces": "vbcs_tpu/ops/pallas_trspmv2d.py:336, "
                     "vbcs_tpu/ops/pallas_trspmv2.py:435",
         "launches": launches["tr_spmv_2d"], "max_abs_err": errs["tr_spmv_2d"],
         "ms": ms["tr_spmv_2d"][0], "plain_ms": ms["tr_spmv_2d"][1]},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all, the build "
          f"included", flush=True)
    print(smi)
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
