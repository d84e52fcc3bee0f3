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
   boundary, a 600 x 900 rectangle, a U=W=8 default plan, a pack with a
   height-0 tile and an empty stripe, stripes wider than a warp (w = 33,
   40, 64), tiles taller than 32 / w rows and one tile per stripe; the
   gather on a masked random permutation and the tile copy on random tile
   lists (bitwise);
4. the main path at flagship scale: ``blocky_matrix()`` (320,000
   columns, ~2.55M nonzeros) through ``VBCOperator.from_csc(A, W=8,
   device="cuda")``, ``tr_mul`` with alpha/beta/y and ``mul``, then
   ``tr_mul_mat`` at k=128 and ``mul_mat`` at k=32, checked against the
   host oracle and the f64 scipy product (``mul_mat`` by the ordered
   scatter on A's pack, which ``operator.forward_pack`` picks for it,
   ``mul`` on its A.T pack's route; phase 8 times the scatter beside the
   gather on A.T's pack);
5. the auto-RCM path: the scrambled FEM ``fem_matrix(k=320)``
   through ``from_csc(..., reorder="auto")``, the same calls (SpMM at
   k=32) on the packs' natural views (``col_out``), one launch a call;
6. the scattered matrix ``scattered_matrix()`` (82,654 columns,
   574k nonzeros: the regime that sends the JAX SpMM to its v1
   fallback; auto-RCM relabels it), ``tr_mul_mat`` at k=32;
7. the 2-D operator at full width, ``VBC2DOperator.from_csc``: (a)
   ``blocky2d_matrix()`` (40,000 x 80,000) under the JAX bench's
   equi plan (U=4, W=8), (b) the flagship under the default five-pass
   planner at U=W=8 (mixed tile heights); ``tr_mul`` with alpha/beta/y
   and ``mul`` against the f64 oracle and the scipy product,
   ``tr_mul_mat`` at k=128 and ``mul_mat`` at k=32;
8. per-call device times from CUDA events, kernel beside plain version
   and beside one library call that computes the same function (cuSPARSE
   SpMV/SpMM through a ``torch.sparse_csr_tensor`` of ``A.T``,
   ``index_select``, a view/transpose/reshape; timed, never called by the
   port), each kernel's bound (the larger of its bytes over 3.35 TB/s and
   its f32 operations over 67 TFLOP/s, computed from this run's inputs:
   the matrix's nonzeros, their index arrays, the vectors; a pack's stored
   fill is not counted), the stripe kernel on the flagship warm and
   L2-flushed and on ``blocky_matrix(**BLOCKY_ABOVE_L2)`` (16x its
   stripes, ~250 MB a call, built through ``VBCOperator.from_csc``, held
   against the f64 product, its plain version and the library first;
   back-to-back and flushed: the ``x16_*`` fields of its ``kernels``
   entry), its staged map on the natural views of the benchmark's
   two TrSpMV cells' relabeled packs (``stripe_ab.CELLS``, from
   ``spbench/gen``, through ``from_csc(A, W=8, reorder="always")``: ~2.1M
   and ~1.5M stripes about 2 wide; the map checked staged, each call one
   staged launch after a reset, held against the plain version bare, with
   alpha/beta/y and into a longer ``out=`` through ``col_out``, two
   launches bitwise; the ``kernels`` line's ``tr_spmv_staged`` entry),
   its float4 map on the pack ``blocky_w8``'s cell runs under auto-RCM,
   unpermuted (``reorder="never"``: 640,000 stripes 8 wide; the same
   checks, each call one ``quad`` launch; the ``cells`` field of the
   ``tr_spmv`` entry) and its f64 staged map on
   the float64 cell's natural view (``stripe_ab.F64_CELLS``, the same
   checks at 1e-14, the bound at 8 bytes an element; the ``kernels``
   line's ``tr_spmv_staged_f64`` entry),
   the tile kernel also beside the stripe kernel on the same matrix's 1-D
   view and beside itself on a one-tile pack (its launch floor), the
   chain beside ``CHAIN_ITERS`` stripe-kernel launches and as many
   library calls, beside itself at a shared-memory budget of 0
   (streamed), and beside its barrier floor (a 1,024-column diagonal
   pack at the full grid), with its grid and the share of each pack
   resident in shared memory, the scatter kernel on the scattered A
   (warm and flushed) and on the flagship's A.T (also without its two
   longest columns), the scatter and stripe kernels on each of the six
   packs of phases 4-6 (the route's guard, a ``GUARD {...}`` line), the
   operators' per-call time on the host clock, and the auto-RCM
   ``tr_mul`` and ``tr_mul_mat`` of the FEM and the scattered operators
   beside the composed gather path and the half-fused one (a
   ``RELABEL {...}`` line);
9. the chain at full width: ``tr_mul_chain`` on the flagship and FEM
   operators, 5 iterations against the f64 oracle, then the timed 100
   at alpha 0.999 (the JAX bench's setting); the FEM's (auto-RCM) with
   its perm folded into the chain kernel, bitwise against and timed
   beside the composed path it replaced (gather x, the chain, gather y:
   a ``CHAINFOLD {...}`` line);
10. the scatter path: ``tr_mul``/``mul`` on the scattered matrix's
    operator against the f64 product, and the route of each of the six
    packs;
11. the standalone relayout op at the flagship's R = 313;
12. the probes (``vbcs_tpu_torch/probes``, the ports of
    ``bench_tools/probe_*.py``) through their entry points: the launch
    probe (one and two ``add_one`` launches a step, the elementwise and
    pad steps, eager on the caller's clock and as CUDA graphs, the ctypes
    path and its parts), both chunk probes (every variant warm and with
    L2 flushed beside its bound), the chain probe (A-D, the marginal
    iteration, beside the chain's barrier floor of phase 8) and the SpMM
    load-path probe (the FMA kernel beside ``torch.einsum``, the row
    gather); then every variant of the four probe kernels against its
    plain version at full size; the relayout's time beside the launch
    probe's floor;
13. the non-f32 routes: the flagship and the auto-RCM FEM as f64
    operators at full size (``tr_mul`` with alpha/beta/y and ``mul`` on
    the stripe kernel's f64 map, one launch each; ``tr_mul_mat``/
    ``mul_mat`` at k=32 and ``tr_mul_chain`` x5 on ``ops/semiring.py``)
    against scipy's f64 products (``SEMI_TOL``),
    ``Pajek/GD99_c`` as int32 and bool operators (1-D and 2-D) exact, and
    the f64 flagship ``tr_mul`` timed beside the f32 kernel, the f64
    library call, an int32 call and the CSC baseline (``ops/csr.py``) in
    f32 and f64 (a ``SEMIRING {...}`` line);
14. the autotuner (``models/autotune.py``) on the card at cut sizes: the
    1-D fit at W=8 and the 2-D fit at U=W=4 into a fresh cache under
    ``build/``, the tables, the fit's residual with and without the E
    column and with a per-call constant, one sample warm and L2-flushed,
    and p/m (predicted over measured) of the min-memory and min-time
    plans on the flagship and the RCM'd FEM (an ``AUTOTUNE {...}`` line);
15. the method table (``vbcs_tpu_torch.tools.method_table``) on the
    flagship with phase 14's models (a ``TABLE [...]`` line);
16. the distributed paths (``vbcs_tpu_torch.parallel``) at full width in
    two worlds, four gloo ranks sharing the card and one NCCL rank: the
    flagship sharded by stripes through ``parallel/spmv.py``'s four calls
    (SpMM at k=128), the replicated, halo and overlapped-halo stream
    paths and the column-stripe path; ``blocky2d_matrix()`` (equi U=4,
    W=8) and a pack whose tiles straddle two ranks' x through the 2-D
    replicated and halo paths; each result against the f64 product and
    the single-device result on the card, each kernel a path runs (the
    tile copy of the halo paths included) against its plain version on
    that path's inputs on every rank, each rank's shard (columns, stored
    values, halo tiles against its own, local stripes) and the time of
    each of its kernels (CUDA events), each path's host wall; then
    ``entry()`` and
    ``dryrun_multichip(4, backend="gloo")`` (a ``DIST {...}`` line); and
    the tile copy alone on the send lists of the flagship's and 2-D (a)'s
    four ranks and 2-D (a)'s pools, beside its plain version and
    ``index_select`` on the tile view (a ``TILES {...}`` line);
17. the split-point DP on the card (``dp_partition_device``,
    ``dp_partition_device_2d``; ``csrc/dp.cu``, ``csrc/dp_scan.cu``,
    ``csrc/dp_checked.cu``): the flagship and the scrambled FEM at W=8
    (1-D), ``blocky2d_matrix()`` under ``SplitPartition.equi(m, 4)`` and
    the flagship under ``equi(m, 8)`` (2-D), with the memory models (exact
    tables: the scan's route) and again with phase 14's fitted time models
    (the 2-D one at U=W=4; fractional: the checked fold on the scan's back
    pointers), and the flagship at W = 16; every plan's split points
    against the host C++ DP's, its route, the checked fold's restarts and
    re-walked rows, and the host ms of each stage of its wall (index copy,
    sort, table, recurrence, backtrack); the four kernels (the stripe-cost
    table, the scan, the checked fold, the serial fold) bitwise against
    their plain versions on each matrix's first 4,096 columns (the checked
    fold with the scan's guess and with one whose every 97th pointer is
    moved, which must restart, and against the serial fold), the scan also
    on the whole flagship; each pass's device time beside the plan's host
    wall and the host DP's; the checked fold (with the scan and alone)
    beside the serial fold in turns on the whole flagship time plan, on
    the flagship's memory S at W = 16 and on a fractional table at W = 16,
    each bitwise with both guesses; the serial fold beside its n-step
    dependent floor (a ``PLAN {...}`` line); then ``probes/probe_pack.py`` (every host stage
    of plan and pack, a ``PACK {...}`` line) and
    ``tools/weak_scaling.py`` at ``WEAK_L0`` stripes a rank (N = 1 on one
    NCCL rank, N = 2 in gloo ranks sharing the card; a ``WEAK {...}``
    line).

The four matrices are the JAX bench's generators (``bench.py``), copied
into ``vbcs_tpu_torch/tools/matrices.py``: the script reads no file of
the JAX side.

Phase 8's ``GUARD {...}`` line also holds the guards' extra packs: 1-D
packs of uniform stripe width 2, 3 and 4 at the flagship's size (scatter
against stripe, about ``MAX_MEAN_WIDTH``) and 2-D packs of uniform tile
height 1, 2, 4 and 8 beside phase 7's two plans (the tile kernel against
the stripe kernel on the 1-D view, about ``TILE2D_MIN_HEIGHT``).

Phase 3 also holds the chain (n_iters 1, 2, 5; alpha None and 0.5; the
square corpus, a multi-class DP plan, long stripes) against its plain
version and the f64 oracle, with its pack resident in shared memory,
partly resident (a budget of half the largest block range) and streamed
(budget 0), the scatter kernel on width-1 packs (the
corpus, a rectangle, a 90-entry column beside an empty one, columns of
14 and 40, a 10,000-entry column, every third column empty; two calls
bitwise equal), the stripe, scatter and SpMM kernels through ``col_out``
on natural views of randomly relabeled square matrices, and the
relayout at R = 1, 3, 313 (bitwise); and the
repaired iteration count of the chain: a launch whose grid-barrier
counter starts 5 rounds short of 2^32, and a chain split across launches
at a cap of 3 iterations a launch.

Each path is driven between a reset and a read of the launch counts:
``tr_mul``/``mul`` of phases 4-5 (each call one launch of its route's
kernel, stripe or scatter TrSpMV; no gather and no ``index_select``),
the SpMM calls of phases 4-6 (SpMM kernel, one a call; no gather, no
``index_select``), the 2-D calls of phase 7 (the tile TrSpMV or the
stripe TrSpMV on the view, as each pack's route says, and the SpMM
kernel on the 1-D views), the four
``tr_mul_chain`` calls of phase 9 (one chain launch each, no gather: the
FEM's perm is in the chain kernel), the scattered ``tr_mul``/``mul`` of
phase 10 (scatter TrSpMV, one a call, no gather),
the relayout of phase 11, the five probes of phase 12 (the launch,
chunk, chain-probe and FMA kernels), the autotuner of phase 14 and the
method table of phase 15 (the routed kernels), and each distributed
path of phase 16 on every rank (counted in the ranks, summed over them:
the stripe, scatter, SpMM and tile TrSpMV kernels, and the tile copy on
the halo paths: one a 1-D halo or overlapped call, two a 2-D halo call,
no element gather), and the plans of phase 17 (the DP's table once a plan, the
scan once, and on fitted tables the checked fold once; the serial fold,
timed as the checked fold's yardstick, on no plan).  No f32 call of phases
4-10 enters ``ops/semiring.py`` (a spy counts), and phase 13's calls do.
Then each kernel is held against its
plain version at the shapes those paths gave it: the stripe kernel on
both packs of both operators (the FEM's natural views), the gather on
the FEM operator's
permutation and its inverse (bitwise; on no path, the chain kernel
taking the perm itself, and timed there as the kernels line's
``gather``), the SpMM
kernel on both packs of
all five operators with their RHS, the tile kernel on the four 2-D
packs, the chain on the flagship and FEM packs (resident, partly
resident and streamed; the FEM's also through its perm, as
``tr_mul_chain`` calls it), the tile copy on the halo paths' send lists
and pools (bitwise), the scatter kernel on
every scatter-route pack, the relayout at R = 313 (bitwise), the
probe kernels on their probes' inputs, and (phase 16) every kernel of a
distributed path on the inputs that path gave it on each rank.
The next-to-last line is the kernels' JSON record; the last line is the
run's JSON result.  It imports no JAX: the JAX package is the reference,
not a dependency.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch import entry as vt_entry
from vbcs_tpu_torch import native
from vbcs_tpu_torch.models import autotune
from vbcs_tpu_torch.ops import _lib, semiring
from vbcs_tpu_torch.ops import chain as chain_op
from vbcs_tpu_torch.ops.chain import chain_grid, chain_plan
from vbcs_tpu_torch.ops.scatter import MAX_MEAN_WIDTH, scatter_admits
from vbcs_tpu_torch.operator import TILE2D_MIN_HEIGHT
from vbcs_tpu_torch.ops.trspmv2d import lanes_per_stripe
from vbcs_tpu_torch.ops.trspmv import stage_plan, thread_map
from vbcs_tpu_torch.parallel import comm, shard, stream
from vbcs_tpu_torch.probes import chunk as probe_chunk
from vbcs_tpu_torch.probes import (probe_chain, probe_kernel, probe_kernel2,
                                   probe_launch, probe_spmm4)
from vbcs_tpu_torch.probes._common import marginal_ms
from vbcs_tpu_torch.probes import probe_pack
from vbcs_tpu_torch.ops import dp as dp_ops
from vbcs_tpu_torch.plan.device_dp import STAGES, dp_inputs, dp_route, dp_stages
from vbcs_tpu_torch.plan.dynamic import dp_partition
from vbcs_tpu_torch.tools import method_table, stripe_ab, weak_scaling
from vbcs_tpu_torch.tools.spmm_ab import work as tr_spmm_work
from vbcs_tpu_torch.utils.timing import flushed_ms, host_ms, paired_ms
from vbcs_tpu_torch.utils import trace

from vbcs_tpu_torch.tools.matrices import (BLOCKY_ABOVE_L2, blocky2d_matrix,
                                           blocky_matrix, fem_matrix,
                                           scattered_matrix)

# |kernel - reference| / max|reference|: f32 sums in another order than
# the plain version (atomics) and the f64 oracle
TOL = 2e-5
TOL_F64 = 1e-14  # the f64 stripe kernel (fma) against its plain version (multiply, add)
SPMM_K = (1, 5, 32, 128, 130)  # scalar path, float4 path, two 128-col tiles
KERNELS = (vt.tr_spmv, vt.gather, vt.gather_tiles, vt.tr_spmm, vt.tr_spmv_2d,
           vt.tr_spmv_chain, vt.tr_spmv_scatter, vt.tile_relayout, vt.mul_ordered)
# the probes' kernel wrappers (phase 12)
PROBES = (probe_launch.add_one, probe_chunk.chunk, probe_chain.chain,
          probe_spmm4.fma)
CHAIN_ITERS = 100  # the timed chain, at the JAX bench's alpha (bench.py:495)
# the chain probe's marginal iterations (us) before its pack was held in
# shared memory (the streaming walk, a thread a column), on an H100 80GB
# HBM3 at 700 W: PERF.md, row 16
STREAMING_CHAIN_US = {"A": 6.43, "B": 5.93, "C": 5.64, "D": 10.28}
CHAIN_ALPHA = 0.999
# H100 SXM data sheet: device-memory rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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


def zero_height_pack(pkg=vt):
    """A 6 x 7 pack with an empty row block, a zero-width stripe, an empty
    stripe, and a tile of height 0 (row block 1) first in stripe 0 — built
    with ``pkg``'s ``pack_vbc2d``/``VBC2D`` (this port's by default)."""
    D = np.zeros((6, 7), np.float32)
    D[0:2, 0:3] = [[1, 2, 3], [4, 5, 6]]
    D[5, 5:7] = [7, 8]
    B2 = pkg.pack_vbc2d(pkg.CSC.from_scipy(sp.csc_matrix(D)),
                        pkg.SplitPartition(np.array([0, 2, 2, 5, 6])),
                        pkg.SplitPartition(np.array([0, 3, 3, 5, 7])), 3, 3)
    pos = B2.pos + (np.arange(B2.pos.size) >= 1)
    return pkg.VBC2D(m=B2.m, n=B2.n, U=B2.U, W=B2.W, Pi=B2.Pi, Phi=B2.Phi,
                     pos=pos, idx=np.insert(B2.idx, 0, 1), ofs=B2.ofs,
                     val=B2.val)


def lane_group_packs():
    """2-D packs for the tile kernel's lane layout: stripes wider than a
    warp (w = 33, 40, 64: column chunks), tiles taller than 32 / w rows
    (u = 9 at w = 8), and one tile per stripe."""
    def equi(A, U, W):
        return vt.vbc2d(A, U, W, vt.AlternatingPacker(vt.EquiChunker(W),
                                                      vt.EquiChunker(U)))
    rng = np.random.default_rng(24)
    one = sp.csc_matrix(np.kron(np.eye(50, dtype=np.float32),
                                rng.standard_normal((4, 8)).astype(np.float32)))
    return [
        ("wide_w33", equi(banded(300, 330, 6, 40, 25), 3, 33)),
        ("wide_w40", equi(banded(300, 400, 6, 40, 26), 3, 40)),
        ("wide_w64", equi(banded(200, 640, 4, 30, 27), 2, 64)),
        ("tall_u9_w8", equi(banded(900, 400, 12, 60, 28), 9, 8)),
        ("one_tile_stripes", equi(one, 4, 8)),
    ]


def mixed_stripes(B2) -> int:
    """How many stripes of a 2-D pack hold tiles of more than one height."""
    u = B2.Pi.widths()[B2.idx]
    starts = B2.pos[:-1][np.diff(B2.pos) > 0]
    if not starts.size:
        return 0
    return int((np.minimum.reduceat(u, starts)
                != np.maximum.reduceat(u, starts)).sum())


def chain_oracle(A, x, n_iters, alpha):
    """(alpha * A.T)^n_iters @ x in f64 on the host."""
    a = 1.0 if alpha is None else alpha
    AT = sp.csr_matrix(A.T, dtype=np.float64)
    y = np.asarray(x, dtype=np.float64)
    for _ in range(n_iters):
        y = a * (AT @ y)
    return y


def launch_chain(fmt, x, n_iters, alpha, blocks, budget, start=0, perm=None):
    """The chain's C launcher at an explicit grid and shared-memory budget
    a block (``tr_spmv_chain`` takes the largest budget and every block
    that fits it), under ``chain_plan`` for the same pair, its grid
    barrier's counter starting at ``start``, x gathered and y stored
    through ``perm`` where given (both maps): (return code, output).  A comparison
    launch: it is not counted in ``tr_spmv_chain.launches``."""
    plan = chain_plan(fmt, blocks, budget)
    out = torch.empty(fmt.n, device=x.device)
    bufs = torch.empty(2, fmt.n, device=x.device)
    count = torch.empty(1, dtype=torch.int32, device=x.device)
    rc = _lib.load().vbcs_tr_spmv_chain(
        n_iters, fmt.L, plan.buf.data_ptr(), fmt.spl.data_ptr(), fmt.pos.data_ptr(),
        fmt.idx.data_ptr(), fmt.ofs.data_ptr(), fmt.col_stripe.data_ptr(),
        fmt.val.data_ptr(), x.data_ptr(), 1.0 if alpha is None else alpha,
        bufs[0].data_ptr(), bufs[1].data_ptr(), out.data_ptr(),
        None if perm is None else perm.data_ptr(),
        None if perm is None else perm.data_ptr(),
        count.data_ptr(), start, blocks, budget,
        torch.cuda.current_stream(x.device).cuda_stream)
    return rc, out


def chain_bytes(fmt, plan):
    """(bytes of each block's range, bytes resident in each block) of a
    chain plan: values and block rows, 4 bytes each."""
    lo, hi, res = plan.lo[:-1].long(), plan.lo[1:].long(), plan.res.long()
    at = (fmt.ofs + fmt.pos).long()
    return 4 * (at[hi] - at[lo]), 4 * (at[res] - at[lo])


def chain_residencies(fmt, dev):
    """``(label, blocks, budget)`` of three launches of the chain kernel on
    ``fmt``: the wrapper's (the largest budget: the flagship and the FEM
    are then resident in full), one whose budget is half the largest
    block range of the streamed grid as the plan lays it out in shared
    memory (partly resident), and budget 0 (streamed)."""
    blocks0, _ = chain_grid(dev, 0)
    plan = chain_plan(fmt, blocks0, 0)
    at = (fmt.spl + plan.pad + fmt.pos).long()  # shared words, padding included
    half = int((at[plan.lo[1:].long()] - at[plan.lo[:-1].long()]).max()) * 4 // 32 * 16
    return [("resident", *chain_grid(dev)), ("partly resident", *chain_grid(dev, half)),
            ("streamed", blocks0, 0)]


def coo_matrix(m, n, rows, cols, seed):
    """An f32 CSC with normal values at (rows, cols), duplicates summed."""
    vals = np.random.default_rng(seed).standard_normal(len(rows)).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def long_column():
    """A 10,000-entry column among 3,000 scattered entries in 60 columns:
    far longer than a tile of the scatter kernel, so it fills tiles of
    its own."""
    rng = np.random.default_rng(31)
    rows = np.concatenate([np.arange(10_000), rng.integers(0, 12_000, 3000)])
    cols = np.concatenate([np.full(10_000, 3), rng.integers(0, 60, 3000)])
    return coo_matrix(12_000, 60, rows, cols, 31)


def empty_columns():
    """Every third column empty, the first and the last too."""
    rng = np.random.default_rng(32)
    cols = rng.integers(1, 2999, 9000)
    cols = cols[cols % 3 != 0]
    return coo_matrix(2000, 3000, rng.integers(0, 2000, cols.size), cols, 32)


def scatter_packs():
    """1D-VBC packs for the scatter kernel's check: the corpus under a
    width-1 plan, a rectangle, a column of 90 entries (past the JAX
    kernel's 64-entry spill) beside an empty column, columns of 14 and 40
    entries, a column of 10,000 entries among short ones, and every third
    column empty."""
    one = vt.EquiChunker(1)
    heavy = banded(2000, 2000, 6, 200, 21).tolil()
    heavy[:90, 5] = 1.5
    heavy[:, 7] = 0
    heavy = heavy.tocsc()
    heavy.eliminate_zeros()
    packs = [(f"{name} w1", vt.vbc1d(A, 8, one)) for name, A in corpus()]
    packs += [
        ("rectangular_600x900 w1", vt.vbc1d(banded(600, 900, 5, 60, 17), 8, one)),
        ("column_of_90_and_empty", vt.vbc1d(heavy.astype(np.float32), 8, one)),
        ("columns_of_14", vt.vbc1d(banded(800, 700, 14, 100, 22), 8, one)),
        ("columns_of_40", vt.vbc1d(banded(1200, 500, 40, 300, 23), 8, one)),
        ("column_of_10000", vt.vbc1d(long_column(), 8, one)),
        ("every_third_column_empty", vt.vbc1d(empty_columns(), 8, one)),
    ]
    return packs


def same_twice(label, call):
    """Two calls of a kernel give bitwise-equal output (no float atomics);
    returns the first."""
    a, b = call(), call()
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{label}: two calls differ")
    return a


def natural_cases(dev, rng):
    """``(name, matrix, perm, pack, scatter pack)`` on ``dev``: square
    matrices relabeled by a random permutation, packed in relabeled order
    (the default plan and a width-1 CSC) and taken as natural views."""
    cases = [(name, A) for name, A in corpus() if A.shape[0] == A.shape[1]]
    cases.append(("fem_k40", fem_matrix(k=40).astype(np.float32)))
    for name, A in cases:
        perm = rng.permutation(A.shape[0])
        Ap = sp.csc_matrix(A)[perm][:, perm]
        perm_t = torch.from_numpy(perm.astype(np.int32)).to(dev)
        yield (name, A, perm_t,
               vt.VBC1DDevice.from_host(vt.vbc1d(Ap, 8), dev).natural_view(perm_t),
               vt.ScatterDevice.from_host(vt.vbc1d(Ap, 8, vt.EquiChunker(1)),
                                          dev).natural_view(perm_t))


def csr_of_transpose(A, dev, dtype=np.float32):
    """``A.T`` as a CSR tensor on ``dev``: the CSC arrays of ``A`` read as
    CSR, values as ``dtype``.  The library yardstick (cuSPARSE through
    ``torch.sparse``), timed beside the kernels; the port never calls it."""
    A = sp.csc_matrix(A, dtype=dtype)
    A.sort_indices()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int32)),
        torch.from_numpy(A.indices.astype(np.int32)),
        torch.from_numpy(A.data), size=(A.shape[1], A.shape[0])).to(dev)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for the work, the larger of
    its bytes over the device-memory rate and its f32 operations over
    the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nonzeros(A) -> int:
    return int(np.count_nonzero(sp.csc_matrix(A).data))


def index_bytes(fmt, nnz) -> int:
    """Bytes of the index arrays that place ``fmt``'s ``nnz`` nonzeros:
    a row per nonzero and ``colptr`` for the scatter CSC; for a VBC pack
    its stripe splits, block pointers and block rows (and row-block
    splits), not ``ofs`` or ``col_stripe``, which follow from those."""
    if isinstance(fmt, vt.ScatterDevice):
        return 4 * nnz + 4 * fmt.colptr.numel()
    arrays = (fmt.spl, fmt.pos, fmt.idx)
    if isinstance(fmt, vt.VBC2DDevice):
        arrays += (fmt.rspl,)
    return sum(t.numel() * t.element_size() for t in arrays)


def tr_spmv_work(fmt, nnz, with_y, n_iters=1, elem=4):
    """(bytes, flops) that ``y = alpha*A.T@x (+ beta*y)`` needs on the
    matrix of ``fmt`` with ``nnz`` nonzeros: each nonzero's value and
    index (:func:`index_bytes`) and x read once, y in (with_y) and y out
    written once, values and vectors at ``elem`` bytes an element; an FMA
    per nonzero and the scaling per output, for each iteration.  The
    pack's stored fill is not counted."""
    nbytes = elem * nnz + index_bytes(fmt, nnz) + elem * (
        fmt.m + fmt.n * (2 if with_y else 1))
    flops = n_iters * (2 * nnz + fmt.n * (3 if with_y else 1))
    return nbytes, flops


def same_function(label, library, kernel, tol=TOL):
    """Check, once before timing, that a library yardstick computes what
    the kernel computes (``tol`` None: bitwise)."""
    a, b = library(), kernel()
    torch.cuda.synchronize()
    ok = (torch.equal(a, b) if tol is None
          else rel_err(a.cpu().numpy(), b.cpu().numpy()) <= tol)
    check(ok, f"{label}: the library call disagrees with the kernel")


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
        ("zero_height_tile", zero_height_pack()),
        *lane_group_packs(),
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
    n_t = (1, 5, 64, 1000)
    for k in n_t:
        tiles = torch.randint(0, n_g // 1024, (k,), device=dev, generator=g,
                              dtype=torch.int32)
        got, plain = vt.gather_tiles(src, tiles), vt.gather_tiles_plain(src, tiles)
        check(torch.equal(got, plain), f"tile copy of {k} tiles differs from "
                                       f"its plain version")
        errs["gather_tiles"] = max(errs["gather_tiles"],
                                   float((got - plain).abs().max()))
    print(f"[3 kernels] stripe TrSpMV: {n_checks} checks on {len(cases)} "
          f"matrices, worst |Δ|/max|y| {worst_plain:.3e} vs plain, "
          f"{worst_oracle:.3e} vs f64 oracle (tol {TOL}); SpMM: {n_spmm} "
          f"checks at k={SPMM_K}, worst |Δ|/max|Y| {spmm_plain:.3e} vs plain, "
          f"{spmm_oracle:.3e} vs f64 oracle; tile TrSpMV: "
          f"{2 * len(tile_cases)} checks on {len(tile_cases)} 2-D packs, worst "
          f"{tile_worst[0]:.3e} vs plain, {tile_worst[1]:.3e} vs f64 oracle; "
          f"gather: {n_g} elements, masked and unmasked, bitwise equal; tile "
          f"copy: {n_t} tiles of a {n_g}-element source, bitwise equal",
          flush=True)


def phase_kernels_slice4(dev, errs):
    """The chain, scatter and relayout kernels against their plain
    versions (and the chain and scatter against the f64 oracle)."""
    rng = np.random.default_rng(10)
    cases = [(name, A, 8, None) for name, A in corpus() if A.shape[0] == A.shape[1]]
    cases += [
        ("multiclass_dp_w4", banded(500, 500, 5, 60, 12), 4,
         vt.DynamicTotalChunker(vt.model_1dvbc_memory(4, 4), 4)),
        ("long_multigroup_stripes", long_stripes(), 8, vt.EquiChunker(8)),
    ]
    worst = [0.0, 0.0]
    n_res = 0
    for name, A, W, method in cases:
        fmt = vt.VBC1DDevice.from_host(vt.vbc1d(A, W, method), dev)
        x = rng.standard_normal(A.shape[0]).astype(np.float32)
        xt = torch.from_numpy(x).to(dev)
        for n_iters in (1, 2, 5):
            for alpha in (None, 0.5):
                got = vt.tr_spmv_chain(fmt, xt, n_iters, alpha)
                plain = vt.tr_spmv_chain_plain(fmt, xt, n_iters, alpha)
                got, plain = got.cpu().numpy(), plain.cpu().numpy()
                e_p = rel_err(got, plain)
                e_o = rel_err(got, chain_oracle(A, x, n_iters, alpha))
                check(np.isfinite(got).all() and got.shape == (A.shape[1],),
                      f"{name}: bad chain output")
                check(e_p <= TOL and e_o <= TOL,
                      f"{name}: chain x{n_iters} off by {e_p:.2e} (plain), "
                      f"{e_o:.2e} (oracle)")
                # values grow as ||alpha*A||^k here: the relative error is
                # checked, and the record's absolute one comes from the
                # path's shapes, at a bounded alpha
                worst = [max(worst[0], e_p), max(worst[1], e_o)]
        # the same kernel with its pack partly resident and streamed
        plain = vt.tr_spmv_chain_plain(fmt, xt, 5, 0.5).cpu().numpy()
        oracle = chain_oracle(A, x, 5, 0.5)
        for label, blocks, budget in chain_residencies(fmt, dev)[1:]:
            rc, got = launch_chain(fmt, xt, 5, 0.5, blocks, budget)
            _lib.check(_lib.load(), rc, f"{name} chain, {label}")
            got = got.cpu().numpy()
            e_p, e_o = rel_err(got, plain), rel_err(got, oracle)
            check(np.isfinite(got).all() and e_p <= TOL and e_o <= TOL,
                  f"{name}: chain {label} off by {e_p:.2e} (plain), {e_o:.2e} "
                  f"(oracle)")
            worst = [max(worst[0], e_p), max(worst[1], e_o)]
            n_res += 1

    packs = scatter_packs()
    sc_worst = [0.0, 0.0]
    for name, B in packs:
        fmt = vt.ScatterDevice.from_host(B, dev)
        e = check_tr(name, vt.tr_spmv_scatter, vt.tr_spmv_scatter_plain, B, fmt,
                     rng, dev, errs)
        sc_worst = [max(a, b) for a, b in zip(sc_worst, e)]
        x, y = torch.randn(fmt.m, device=dev), torch.randn(fmt.n, device=dev)
        same_twice(name, lambda: vt.tr_spmv_scatter(fmt, x, 0.5, 0.25, y))
    # the three kernels through col_out, on natural views of relabeled packs
    nat_worst = 0.0
    n_nat = 0
    for name, A, perm_t, fmt, sfmt in natural_cases(dev, rng):
        x = rng.standard_normal(A.shape[0]).astype(np.float32)
        y = rng.standard_normal(A.shape[1]).astype(np.float32)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        A64 = A.astype(np.float64)
        for kernel, plain, f in ((vt.tr_spmv, vt.tr_spmv_plain, fmt),
                                 (vt.tr_spmv_scatter, vt.tr_spmv_scatter_plain, sfmt)):
            for args, want in (((), A64.T @ x),
                               ((0.5, 0.25, yt), 0.5 * (A64.T @ x) + 0.25 * y)):
                got = kernel(f, xt, *args)
                ref = plain(f, xt, *args)
                e = max(rel_err(got.cpu().numpy(), ref.cpu().numpy()),
                        rel_err(got.cpu().numpy(), want))
                check(e <= TOL, f"{name} natural view: {kernel.__name__} off by {e:.2e}")
                errs[kernel.__name__] = max(errs[kernel.__name__],
                                            float((got - ref).abs().max()))
                nat_worst = max(nat_worst, e)
                n_nat += 1
        for k in (5, 32):
            X = rng.standard_normal((A.shape[0], k)).astype(np.float32)
            Xt = torch.from_numpy(X).to(dev)
            got, ref = vt.tr_spmm(fmt, Xt), vt.tr_spmm_plain(fmt, Xt)
            e = max(rel_err(got.cpu().numpy(), ref.cpu().numpy()),
                    rel_err(got.cpu().numpy(), A64.T @ X))
            check(e <= TOL, f"{name} natural view: SpMM at k={k} off by {e:.2e}")
            errs["tr_spmm"] = max(errs["tr_spmm"], float((got - ref).abs().max()))
            nat_worst = max(nat_worst, e)
            n_nat += 1

    for R, m in ((1, 1000), (3, 3000), (313, 320_000)):
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
        got, plain = vt.tile_relayout(x, R), vt.tile_relayout_plain(x, R)
        check(got.shape == (8, R * 128) and torch.equal(got, plain),
              f"tile relayout differs from its plain version at R={R}")
        errs["tile_relayout"] = max(errs["tile_relayout"],
                                    float((got - plain).abs().max()))
    print(f"[3 kernels, slice 4] chain: {6 * len(cases)} checks (n_iters 1, 2, "
          f"5; alpha None, 0.5) on {len(cases)} square matrices, resident, and "
          f"{n_res} partly resident or streamed (x5), worst |Δ|/max|y| "
          f"{worst[0]:.3e} vs plain, {worst[1]:.3e} vs f64 oracle; scatter: "
          f"{2 * len(packs)} checks on {len(packs)} packs, worst "
          f"{sc_worst[0]:.3e} vs plain, {sc_worst[1]:.3e} vs f64 oracle, two "
          f"calls bitwise equal on each; natural views (col_out) of relabeled "
          f"packs: {n_nat} checks of the stripe, scatter and SpMM kernels, worst "
          f"{nat_worst:.3e} vs plain and f64; relayout at R = 1, 3, 313: bitwise "
          f"equal", flush=True)


def phase_chain_repair(dev):
    """The chain's iteration count: a launch whose grid-barrier counter
    starts 5 rounds short of 2^32 (the targets of rounds 5-9 wrap), and a
    chain split across launches at a cap of 3 iterations a launch (10 =
    3 + 3 + 3 + 1), each against the plain loop."""
    fmt = vt.VBC1DDevice.from_host(vt.vbc1d(blocky_matrix(L=2048), 8), dev)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(fmt.m).astype(
        np.float32)).to(dev)
    blocks, budget = chain_grid(dev)
    rc, got = launch_chain(fmt, x, 10, 0.25, blocks, budget, start=2**32 - 5 * blocks)
    _lib.check(_lib.load(), rc, "chain with a wrapping barrier counter")
    e_wrap = rel_err(got.cpu().numpy(),
                     vt.tr_spmv_chain_plain(fmt, x, 10, 0.25).cpu().numpy())
    cap = chain_op.MAX_LAUNCH_ITERS
    chain_op.MAX_LAUNCH_ITERS = 3
    try:
        before = vt.tr_spmv_chain.launches
        got = vt.tr_spmv_chain(fmt, x, 10, 0.5)
        n_launches = vt.tr_spmv_chain.launches - before
    finally:
        chain_op.MAX_LAUNCH_ITERS = cap
    e_split = rel_err(got.cpu().numpy(),
                      vt.tr_spmv_chain_plain(fmt, x, 10, 0.5).cpu().numpy())
    check(e_wrap <= TOL and e_split <= TOL and n_launches == 4,
          f"chain repair: counter wrap off by {e_wrap:.2e}, split ({n_launches} "
          f"launches) off by {e_split:.2e}")
    print(f"[3 chain repair] barrier counter from 2^32 - 5 x {blocks} blocks, 10 "
          f"iterations: |Δ|/max|y| {e_wrap:.3e} vs plain; chain of 10 at "
          f"{3} iterations a launch: {n_launches} launches, {e_split:.3e} vs "
          f"plain (tol {TOL})", flush=True)


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
        launched = (vt.tr_spmv_2d.launches, vt.tr_spmv.launches)
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
        tiles = vt.tr_spmv_2d.launches - launched[0]
        views = vt.tr_spmv.launches - launched[1]
        routes = (op.route_tr[0], op.route_fw[0])
        check(tiles == routes.count("tile2d") and views == routes.count("view"),
              f"2-D part ({part}): routes {routes}, but {tiles} tile and {views} "
              f"stripe launches")
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
              f"to device) {t_op:.3f} s; mean tile height "
              f"{vt.mean_tile_height(B):.3f} (A), "
              f"{vt.mean_tile_height(op.host_fw):.3f} (A.T): routes tr_mul "
              f"{routes[0]}, mul {routes[1]}, tile launches {tiles}, stripe "
              f"launches {views}; |Δ|/max vs f64 "
              f"oracle and scipy: tr_mul(alpha, beta, y) {errs['tr_mul']:.3e}, "
              f"mul {errs['mul']:.3e}, tr_mul_mat k=128 "
              f"{errs['tr_mul_mat']:.3e}, mul_mat k=32 {errs['mul_mat']:.3e}",
              flush=True)
        parts[part] = (A, op, xt, yt, xft, Xt, Xft)
    return parts


def phase_chain(flag, fem):
    """``tr_mul_chain`` on the flagship and the auto-RCM FEM operators:
    5 iterations at alpha = 1 / ||A||_1 (so |y| stays bounded) against the
    f64 oracle, then the timed chain of ``CHAIN_ITERS`` at
    ``CHAIN_ALPHA`` once.  Returns, per operator, the matrix, the
    operator, x and the checked alpha."""
    out = {}
    for label, (A, op, xt, _) in (("flagship", flag), ("FEM", fem)):
        alpha = float(1.0 / abs(A).sum(axis=0).max())
        launched = vt.tr_spmv_chain.launches
        got = op.tr_mul_chain(xt, 5, alpha)
        timed = op.tr_mul_chain(xt, CHAIN_ITERS, CHAIN_ALPHA)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        check(vt.tr_spmv_chain.launches - launched == 2,
              f"{label}: a tr_mul_chain call was not one chain launch")
        check(got.shape == (op.n,) and timed.shape == (op.n,)
              and np.isfinite(got).all(), f"{label}: bad chain output")
        e = rel_err(got, chain_oracle(A, xt.cpu().numpy(), 5, alpha))
        check(e <= TOL, f"{label}: tr_mul_chain x5 off the f64 oracle by {e:.2e}")
        print(f"[9 chain {label}] {op.m}x{op.n}, "
              f"{'relabeled' if op.row_perm is not None else 'natural'}; "
              f"tr_mul_chain(x, 5, alpha=1/||A||_1={alpha:.4g}) |Δ|/max {e:.3e} "
              f"vs f64 oracle; tr_mul_chain(x, {CHAIN_ITERS}, {CHAIN_ALPHA}) "
              f"ran (values grow as ||alpha*A||^k; not checked)", flush=True)
        out[label] = (A, op, xt, alpha)
    return out


def phase_scatter(dev, flag, fem, spmm):
    """``tr_mul``/``mul`` on ``scattered_matrix()`` (its operator from
    phase 6) against the f64 scipy product, and the route each of the six
    packs of phases 4-6 takes."""
    A = scattered_matrix().astype(np.float32)
    op = spmm["scattered"][0]
    rng = np.random.default_rng(11)
    x = rng.standard_normal(op.m).astype(np.float32)
    y = rng.standard_normal(op.n).astype(np.float32)
    xf = rng.standard_normal(op.n).astype(np.float32)
    xt, yt, xft = (torch.from_numpy(a).to(dev) for a in (x, y, xf))
    got_tr = op.tr_mul(xt, 0.5, 0.25, yt)
    got_fw = op.mul(xft)
    torch.cuda.synchronize()
    A64 = A.astype(np.float64)
    got_tr, got_fw = got_tr.cpu().numpy(), got_fw.cpu().numpy()
    check(got_tr.shape == (op.n,) and np.isfinite(got_tr).all()
          and got_fw.shape == (op.m,) and np.isfinite(got_fw).all(),
          "scattered: bad tr_mul/mul output")
    e_tr = rel_err(got_tr, 0.5 * (A64.T @ x) + 0.25 * y.astype(np.float64))
    e_fw = rel_err(got_fw, A64 @ xf)
    check(e_tr <= TOL and e_fw <= TOL,
          f"scattered off the f64 product: tr_mul {e_tr:.2e}, mul {e_fw:.2e}")
    routes = {}
    for label, o in (("flagship", flag[1]), ("FEM", fem[1]), ("scattered", op)):
        for direction, host, route in (("A", o.host_tr, o.route_tr),
                                       ("A.T", o.host_fw, o.route_fw)):
            routes[f"{label} {direction}"] = (
                float(np.diff(host.Phi.spl).mean()), route[0])
    check(routes["scattered A"][1] == routes["scattered A.T"][1] == "scatter",
          "the scattered matrix is not on the scatter route")
    print(f"[10 scatter] scattered {op.m}x{op.n}, "
          f"{'relabeled' if op.row_perm is not None else 'natural'}; "
          f"tr_mul(alpha, beta, y) |Δ|/max {e_tr:.3e}, mul {e_fw:.3e} vs f64 "
          f"scipy product; routes at MAX_MEAN_WIDTH = {MAX_MEAN_WIDTH} (pack: "
          f"mean stripe width, route): "
          + ", ".join(f"{k} {w:.3f} {r}" for k, (w, r) in routes.items()),
          flush=True)
    return A, op, xt, yt, xft, routes


def phase_relayout(dev):
    """The standalone relayout op at the flagship's R (320,000 -> 313
    blocks of 1,024): no operator calls it."""
    m = 320_000
    R = -(-m // 1024)
    x = torch.from_numpy(
        np.random.default_rng(12).standard_normal(m).astype(np.float32)).to(dev)
    out = vt.tile_relayout(x, R)
    torch.cuda.synchronize()
    tail = m - (R - 1) * 1024  # elements in the last, zero-padded block
    check(out.shape == (8, R * 128)
          and torch.equal(out[:, :128].reshape(-1), x[:1024])
          and not out[tail // 128:, (R - 1) * 128:].any(),
          "relayout: bad output")
    print(f"[11 relayout] tile_relayout(x[{m}], R={R}) -> (8, {R * 128})",
          flush=True)
    return x, R


def phase_path_shapes(flag, fem, spmm, errs):
    """Each kernel against its plain version on the formats, permutations,
    vectors and RHS of phases 4-6 (after the launch counts are read)."""
    worst = 0.0
    for label, (_, op, xt, yt) in (("flagship", flag), ("FEM", fem)):
        # natural order: the FEM's are the natural views (col_out)
        for direction, fmt in (("tr_mul", op.nat_tr), ("mul", op.nat_fw)):
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
    for name, src, perm in (("perm", xt2, op2.perm_t),
                            ("inverse", yt2, torch.argsort(op2.perm_t).int())):
        got, plain = vt.gather(src, perm), vt.gather_plain(src, perm)
        check(torch.equal(got, plain),
              f"gather of the FEM {name} permutation differs from its plain version")
        errs["gather"] = max(errs["gather"], float((got - plain).abs().max()))
    print(f"[4-5 kernels at the path's shapes] stripe TrSpMV on the flagship "
          f"packs and the FEM's natural views, both directions, with and "
          f"without alpha/beta/y: worst |Δ|/max|y| {worst:.3e} vs plain (tol "
          f"{TOL}); gather of the FEM perm (x) and inverse (y), the composed "
          f"chain path's: bitwise equal", flush=True)

    worst = 0.0
    for label, (op, Xt, Xft) in spmm.items():
        for direction, fmt, X in (("tr_mul_mat", op.nat_tr, Xt),
                                  ("mul_mat", op.nat_fw, Xft)):
            if X is None:
                continue
            got, plain = vt.tr_spmm(fmt, X), vt.tr_spmm_plain(fmt, X)
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"{label} {direction} pack: SpMM kernel off its "
                            f"plain version by {e:.2e}")
            worst = max(worst, e)
            errs["tr_spmm"] = max(errs["tr_spmm"], float((got - plain).abs().max()))
    print(f"[4-6 SpMM at the path's shapes] SpMM kernel on the flagship pack "
          f"and the FEM and scattered natural views with their RHS: worst "
          f"|Δ|/max|Y| {worst:.3e} vs plain (tol {TOL})", flush=True)


def phase_path_shapes_2d(parts, errs):
    """The tile kernel on the four 2-D packs of phase 7 (both directions of
    both parts), the stripe kernel on the 1-D view of every pack whose
    route is ``"view"``, each with and without alpha/beta/y, and the SpMM
    kernel on their 1-D views with the phase's RHS, each against its plain
    version."""
    worst = worst_mm = worst_view = 0.0
    views = []
    for part, (_, op, xt, yt, xft, Xt, Xft) in parts.items():
        for direction, fmt, route, x, y in (
                ("A", op.dev_tr, op.route_tr, xt, yt),
                ("A.T", op.dev_fw, op.route_fw, xft, xt)):
            for args in ((None, None, None), (0.5, 0.25, y)):
                got = vt.tr_spmv_2d(fmt, x, *args)
                plain = vt.tr_spmv_2d_plain(fmt, x, *args)
                e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
                check(e <= TOL, f"2-D ({part}) pack: tile kernel off its plain "
                                f"version by {e:.2e}")
                worst = max(worst, e)
                errs["tr_spmv_2d"] = max(errs["tr_spmv_2d"],
                                         float((got - plain).abs().max()))
                if route[0] != "view":
                    continue
                got = vt.tr_spmv(route[1], x, *args)
                plain = vt.tr_spmv_plain(route[1], x, *args)
                e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
                check(e <= TOL, f"2-D ({part}) {direction} view route: stripe "
                                f"kernel off its plain version by {e:.2e}")
                worst_view = max(worst_view, e)
                errs["tr_spmv"] = max(errs["tr_spmv"],
                                      float((got - plain).abs().max()))
            if route[0] == "view":
                views.append(f"({part}) {direction}")
        for view, X in ((op.view_tr, Xt), (op.view_fw, Xft)):
            got, plain = vt.tr_spmm(view, X), vt.tr_spmm_plain(view, X)
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"2-D ({part}) 1-D view: SpMM kernel off its plain "
                            f"version by {e:.2e}")
            worst_mm = max(worst_mm, e)
            errs["tr_spmm"] = max(errs["tr_spmm"], float((got - plain).abs().max()))
    check(views, "no 2-D pack of phase 7 is on the view route")
    print(f"[7 kernels at the path's shapes] tile TrSpMV on the four 2-D packs, "
          f"with and without alpha/beta/y: worst |Δ|/max|y| {worst:.3e} vs plain; "
          f"stripe TrSpMV on the view-route packs' 1-D views "
          f"({', '.join(views)}), with and without alpha/beta/y: "
          f"{worst_view:.3e} vs plain; SpMM on their 1-D views: {worst_mm:.3e} "
          f"vs plain (tol {TOL})", flush=True)


def phase_path_shapes_slice4(chains, scat_routes, rel, errs):
    """The chain kernel on the flagship and FEM packs (5 iterations at
    phase 9's alpha), the scatter kernel on every scatter-route pack of
    phases 4-6 and 10, with and without alpha/beta/y, and the relayout at
    phase 11's shape, each against its plain version."""
    worst = worst_sc = 0.0
    for label, (_, op, xt, alpha) in chains.items():
        x = xt if op.row_perm is None else vt.gather(xt, op.perm_t)
        plain = vt.tr_spmv_chain_plain(op.dev_tr, x, 5, alpha)
        runs = [("resident", vt.tr_spmv_chain(op.dev_tr, x, 5, alpha))]
        for res, blocks, budget in chain_residencies(op.dev_tr, x.device)[1:]:
            rc, got = launch_chain(op.dev_tr, x, 5, alpha, blocks, budget)
            _lib.check(_lib.load(), rc, f"{label} chain, {res}")
            runs.append((res, got))
        if op.row_perm is not None:  # the call tr_mul_chain makes
            mapped = vt.tr_spmv_chain(op.dev_tr, xt, 5, alpha, op.perm_t)
            mapped_plain = vt.tr_spmv_chain_plain(op.dev_tr, xt, 5, alpha, op.perm_t)
            e = rel_err(mapped.cpu().numpy(), mapped_plain.cpu().numpy())
            check(e <= TOL, f"{label} chain through its perm off its plain "
                            f"version by {e:.2e}")
            worst = max(worst, e)
            errs["tr_spmv_chain"] = max(errs["tr_spmv_chain"],
                                        float((mapped - mapped_plain).abs().max()))
        for res, got in runs:
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"{label} chain ({res}) off its plain version by "
                            f"{e:.2e}")
            worst = max(worst, e)
            errs["tr_spmv_chain"] = max(errs["tr_spmv_chain"],
                                        float((got - plain).abs().max()))
    g = torch.Generator(device=xt.device).manual_seed(13)
    for label, fmt in scat_routes.items():
        x = torch.randn(fmt.m, device=fmt.device, generator=g)
        y = torch.randn(fmt.n, device=fmt.device, generator=g)
        for args in ((None, None, None), (0.5, 0.25, y)):
            got = same_twice(label, lambda: vt.tr_spmv_scatter(fmt, x, *args))
            plain = vt.tr_spmv_scatter_plain(fmt, x, *args)
            e = rel_err(got.cpu().numpy(), plain.cpu().numpy())
            check(e <= TOL, f"{label} pack: scatter kernel off its plain "
                            f"version by {e:.2e}")
            worst_sc = max(worst_sc, e)
            errs["tr_spmv_scatter"] = max(errs["tr_spmv_scatter"],
                                          float((got - plain).abs().max()))
    x, R = rel
    got, plain = vt.tile_relayout(x, R), vt.tile_relayout_plain(x, R)
    check(torch.equal(got, plain), "relayout differs from its plain version")
    print(f"[9-11 kernels at the path's shapes] chain on the flagship and FEM "
          f"packs, 5 iterations, resident, partly resident and streamed, the "
          f"FEM's also through its perm (tr_mul_chain's call): worst "
          f"|Δ|/max|y| {worst:.3e} vs plain; scatter "
          f"on the {len(scat_routes)} scatter-route formats ("
          f"{', '.join(scat_routes)}; natural views where relabeled), with and "
          f"without alpha/beta/y: {worst_sc:.3e} vs plain (tol {TOL}), two "
          f"calls bitwise equal; relayout at R={R}: bitwise equal", flush=True)


def entry(warm, work):
    """A kernel's timing record from ``paired_ms`` of (kernel, plain,
    library) and its (bytes, flops)."""
    bound_ms, bound_by = bound(*work)
    return {"ms": warm[0], "plain_ms": warm[1], "library_ms": warm[2],
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_timing_2d(dev, parts):
    """Part (a): the tile kernel, its plain version, the library SpMV and
    the stripe kernel on the same matrix's 1-D view, warm and L2-flushed;
    end to end ``tr_mul`` and ``tr_mul_mat``.  Part (b): tile against
    stripe on the 1-D view, warm and flushed (the mixed-height plan).
    Returns the kernels' records and, per part, the tile/view pair (the
    2-D guard's data)."""
    out, pairs = {}, {}
    for part, (A, op, xt, yt, _, Xt, _) in parts.items():
        fmt, view = op.dev_tr, op.view_tr
        calls = [lambda: vt.tr_spmv_2d(fmt, xt, 0.5, 0.25, yt),
                 lambda: vt.tr_spmv(view, xt, 0.5, 0.25, yt)]
        if part == "a":
            AT = csr_of_transpose(A, dev)
            same_function("2-D (a) SpMV",
                          lambda: torch.addmv(yt, AT, xt, beta=0.25, alpha=0.5),
                          calls[0])
            # the kernel's launch floor: the same call on a one-tile pack
            tiny = vt.VBC2DDevice.from_host(vt.vbc2d(sp.csc_matrix(
                np.ones((4, 8), np.float32)), 4, 8), dev)
            x4, y8 = torch.ones(4, device=dev), torch.ones(8, device=dev)
            calls += [lambda: vt.tr_spmv_2d_plain(fmt, xt, 0.5, 0.25, yt),
                      lambda: torch.addmv(yt, AT, xt, beta=0.25, alpha=0.5),
                      lambda: vt.tr_spmv_2d(tiny, x4, 0.5, 0.25, y8)]
        warm = paired_ms(calls, dev)
        cold = [flushed_ms(c, dev) for c in calls[:2]]
        io = 4 * (fmt.m + 2 * fmt.n)  # x, y in, y out
        stored, nnz = fmt.val.numel(), A.nnz
        line = (f"[8 timing 2-D ({part}), {stored} stored values, {nnz} nnz] "
                f"tile kernel ({lanes_per_stripe(fmt)} lanes a stripe) "
                f"{warm[0] * 1e3:.2f} us/call warm, "
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
        pairs[f"2-D ({part})"] = {
            "mean_tile_height": vt.mean_tile_height(op.host_tr),
            "route": op.route_tr[0], "tile2d_us": warm[0] * 1e3,
            "view_us": warm[1] * 1e3, "stored": int(stored)}
        if part == "a":
            out["tr_spmv_2d"] = entry([warm[0], warm[2], warm[3]],
                                      tr_spmv_work(fmt, nonzeros(A), True))
            line += (f"; plain {warm[2] * 1e3:.2f} us warm; library (torch.addmv"
                     f", CSR) {warm[3] * 1e3:.2f} us; bound "
                     f"{out['tr_spmv_2d']['bound_ms'] * 1e3:.2f} us; launch floor "
                     f"(the tile kernel on one 4 x 8 tile) {warm[4] * 1e3:.2f} us")
            e2e, e2e_mat = paired_ms([lambda: op.tr_mul(xt, 0.5, 0.25, yt),
                                      lambda: op.tr_mul_mat(Xt)], dev)
            wall = host_ms(lambda: op.tr_mul(xt, 0.5, 0.25, yt), dev)
            wall_mat = host_ms(lambda: op.tr_mul_mat(Xt), dev)
            line += (f"; end to end, device / host wall per call: tr_mul(alpha, "
                     f"beta, y) {e2e * 1e3:.2f} / {wall * 1e3:.2f} us, tr_mul_mat "
                     f"k=128 {e2e_mat * 1e3:.2f} / {wall_mat * 1e3:.2f} us")
        print(line, flush=True)
    return out, pairs


def without_longest_columns(A, k):
    """``A`` (CSC) with the entries of its ``k`` longest columns dropped,
    and their entry counts."""
    cnt = np.diff(A.indptr)
    top = np.argsort(cnt, kind="stable")[-k:]
    cols = np.repeat(np.arange(A.shape[1]), cnt)
    keep = ~np.isin(cols, top)
    coo = A.tocoo()
    cut = sp.csc_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                        shape=A.shape)
    return cut, [int(c) for c in cnt[top]]


def operator_matrix(A, op):
    """The matrix an operator's packs hold: ``A``, or ``A[perm][:, perm]``
    on a relabeled operator."""
    if op.row_perm is None:
        return A
    return sp.csc_matrix(A)[op.row_perm][:, op.row_perm]


def phase_timing(dev, flag, fem, spmm):
    A, op, xt, yt = flag
    fmt = op.dev_tr
    AT = csr_of_transpose(A, dev)
    same_function("flagship SpMV", lambda: torch.addmv(yt, AT, xt, beta=0.25, alpha=0.5),
                  lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt))
    warm = paired_ms(
        [lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt),
         lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt),
         lambda: torch.addmv(yt, AT, xt, beta=0.25, alpha=0.5)], dev)
    work = tr_spmv_work(fmt, nonzeros(A), True)
    out = {"tr_spmv": entry(warm, work)}
    cold_ms = flushed_ms(lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt), dev)
    cold_plain = flushed_ms(lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt), dev)
    out["tr_spmv"]["flushed_ms"] = cold_ms
    nbytes = work[0]
    k_ms = warm[0]
    print(f"[8 timing tr_spmv, flagship] kernel {k_ms * 1e3:.2f} us/call "
          f"(back-to-back, L2-warm: {nbytes / 1e6:.1f} MB per call), "
          f"{cold_ms * 1e3:.2f} us with L2 flushed; plain {warm[1] * 1e3:.2f} us, "
          f"{cold_plain * 1e3:.2f} us flushed; library (torch.addmv, CSR) "
          f"{warm[2] * 1e3:.2f} us; bound {out['tr_spmv']['bound_ms'] * 1e3:.2f} "
          f"us; {nbytes / (k_ms * 1e6):.1f} GB/s warm, "
          f"{nbytes / (cold_ms * 1e6):.1f} GB/s flushed, "
          f"{A.nnz / (k_ms * 1e6):.2f} Gnnz/s warm", flush=True)

    A2, op2, xt2, yt2 = fem
    perm = op2.perm_t
    same_function("FEM gather", lambda: xt2.index_select(0, perm),
                  lambda: vt.gather(xt2, perm), tol=None)
    warm = paired_ms([lambda: vt.gather(xt2, perm),
                      lambda: vt.gather_plain(xt2, perm),
                      lambda: xt2.index_select(0, perm)], dev)
    out["gather"] = entry(warm, (12 * perm.numel(), 0))
    calls = (lambda: op.tr_mul(xt, 0.5, 0.25, yt), lambda: op.mul(xt, 0.5, 0.25, yt))
    e2e = paired_ms(list(calls), dev)
    wall = [host_ms(c, dev) for c in calls]
    print(f"[8 timing gather, FEM perm of {op2.m}, the chain path's] kernel "
          f"{warm[0] * 1e3:.2f} us/call, plain {warm[1] * 1e3:.2f} us, library "
          f"(index_select) {warm[2] * 1e3:.2f} us; flagship end to end, device / "
          f"host wall per call: tr_mul(alpha, beta, y) ({op.route_tr[0]} route) "
          f"{e2e[0] * 1e3:.2f} / {wall[0] * 1e3:.2f} us, mul(alpha, beta, y) "
          f"({op.route_fw[0]} route) {e2e[1] * 1e3:.2f} / {wall[1] * 1e3:.2f} us",
          flush=True)

    op_f, Xt, _ = spmm["flagship"]
    e2e_mat = paired_ms([lambda: op_f.tr_mul_mat(Xt)], dev)[0]
    wall_mat = host_ms(lambda: op_f.tr_mul_mat(Xt), dev)
    print(f"[8 timing tr_mul_mat, flagship k={Xt.shape[1]}] end to end, device "
          f"/ host wall per call: {e2e_mat * 1e3:.2f} / {wall_mat * 1e3:.2f} us",
          flush=True)
    return out


L2_BYTES = 50 << 20  # flushed SpMM times where X and Y exceed the L2


def spmm_shapes(flag, fem, spmm, parts):
    """Every shape an operator runs the SpMM at on phases 4-7, and the
    flagship's at k = 130: (label, its format, the matrix M with ``Y = M @
    X`` in natural order, the operator's matrix (M's nonzeros), X on the
    card), as ``tools/spmm_ab.py`` runs them."""
    A_s = scattered_matrix().astype(np.float32)
    shapes = []
    for label, A, (op, Xt, Xft) in (("flagship", flag[0], spmm["flagship"]),
                                    ("FEM", fem[0], spmm["FEM"]),
                                    ("scattered", A_s, spmm["scattered"])):
        shapes.append((f"{label} tr_mul_mat", op.nat_tr, A.T, A, Xt))
        if label == "flagship":  # past the JAX v4 SpMM's k <= 128: its v3
            gen = torch.Generator(device=Xt.device).manual_seed(130)
            X130 = torch.randn(Xt.shape[0], 130, generator=gen, device=Xt.device)
            shapes.append((f"{label} tr_mul_mat", op.nat_tr, A.T, A, X130))
        if Xft is not None:
            shapes.append((f"{label} mul_mat", op.nat_fw, A, A, Xft))
    for part, (A, op, _, _, _, Xt, Xft) in parts.items():
        shapes.append((f"2-D ({part}) tr_mul_mat", op.view_tr, A.T, A, Xt))
        shapes.append((f"2-D ({part}) mul_mat", op.view_fw, A, A, Xft))
    return shapes


def phase_timing_spmm(dev, flag, fem, spmm, parts):
    """The SpMM at each of :func:`spmm_shapes`: kernel, plain version and
    the library call (``CSR @ X`` on the same matrix) back-to-back in one
    paired set, L2-flushed where X and Y exceed the L2, beside the bound
    (``tools.spmm_ab.work``).  Returns the kernels line's ``tr_spmm`` entry:
    the flagship's ``tr_mul_mat`` at k = 128, and every shape's record
    under ``shapes``."""
    recs = []
    for label, fmt, M, A, X in spmm_shapes(flag, fem, spmm, parts):
        k = X.shape[1]
        lib = csr_of_transpose(sp.csc_matrix(M.T), dev)
        same_function(f"{label} SpMM", lambda: lib @ X, lambda: vt.tr_spmm(fmt, X))
        calls = [lambda: vt.tr_spmm(fmt, X), lambda: vt.tr_spmm_plain(fmt, X),
                 lambda: lib @ X]
        warm = paired_ms(calls, dev)
        cold = ([flushed_ms(calls[0], dev), flushed_ms(calls[2], dev)]
                if 4 * k * (fmt.m + fmt.n) > L2_BYTES else [None, None])
        rec = {"shape": label, "k": k, **entry(warm, tr_spmm_work(fmt, nonzeros(A), k)),
               "flushed_ms": cold[0], "library_flushed_ms": cold[1],
               "width_class": fmt.width_class, "stripes": fmt.L,
               "blocks": fmt.idx.numel(), "long_stripes": fmt.long_stripes.numel()}
        recs.append(rec)
        flushed = ("" if cold[0] is None else
                   f", {cold[0] * 1e3:.2f} / {cold[1] * 1e3:.2f} us L2-flushed")
        print(f"[8 timing tr_spmm, {label} k={k}] {fmt.L} stripes (mean width "
              f"{fmt.n / fmt.L:.3f}, class {fmt.width_class}), {fmt.idx.numel()} "
              f"blocks, {rec['long_stripes']} long; kernel {warm[0] * 1e3:.2f} us, "
              f"plain {warm[1] * 1e3:.2f} us, library (CSR @ X) {warm[2] * 1e3:.2f} "
              f"us{flushed} (kernel / library); bound {rec['bound_ms'] * 1e3:.2f} "
              f"us ({rec['bound_by']}), {rec['bound_ms'] / warm[0]:.3f} of it",
              flush=True)
    head = next(r for r in recs if r["shape"] == "flagship tr_mul_mat"
                and r["k"] == 128)
    return {**{key: head[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "flushed_ms")},
            "shapes": recs}


def phase_timing_ordered(dev, flag, spmm, errs):
    """The ordered scatter on the flagship's pack of A (its ``mul_mat`` at
    k = 32, where the operator holds its forward products on A's pack):
    kernel, plain version and the library call (``CSR @ X`` of A) in one
    paired set, L2-flushed, beside the gather (``tr_spmm`` on the A.T
    pack's natural view, the route before) and the bound (X, Y, the
    values and the pack's index arrays once); and a vector with
    alpha/beta/y by block beside ``mul``, the A.T pack's route.  Returns
    the kernels line's ``mul_ordered`` entry."""
    A, op = flag[0], flag[1]
    X = spmm["flagship"][2]
    k = X.shape[1]
    check(op.fw_on_a, "the flagship's forward products left A's pack")
    fmt = op.ordered_fw
    lib = csr_of_transpose(sp.csc_matrix(A.T), dev)
    got, again = vt.mul_ordered(fmt, X), vt.mul_ordered(fmt, X)
    plain = vt.mul_ordered_plain(fmt, X)
    torch.cuda.synchronize()
    err = rel_err(got.cpu().numpy(), plain.cpu().numpy())
    check(err <= TOL and torch.equal(got, again),
          f"flagship ordered scatter off its plain version by {err:.2e}, or two "
          f"launches differ")
    errs["mul_ordered"] = max(errs["mul_ordered"], float((got - plain).abs().max()))
    same_function("flagship ordered scatter", lambda: lib @ X,
                  lambda: vt.mul_ordered(fmt, X))
    x, y = X[:, 0].contiguous(), X[:, 1].contiguous()
    vec = vt.mul_ordered(fmt, x, 0.5, 0.25, y)
    err_vec = rel_err(vec.cpu().numpy(), vt.mul_ordered_plain(fmt, x, 0.5, 0.25, y).cpu().numpy())
    check(err_vec <= TOL and torch.equal(vec, vt.mul_ordered(fmt, x, 0.5, 0.25, y)),
          f"flagship ordered scatter by block off its plain version by {err_vec:.2e}, "
          f"or two launches differ")
    calls = [lambda: vt.mul_ordered(fmt, X), lambda: vt.mul_ordered_plain(fmt, X),
             lambda: lib @ X, lambda: vt.tr_spmm(op.nat_fw, X),
             lambda: vt.mul_ordered(fmt, x, 0.5, 0.25, y), lambda: op.mul(x, 0.5, 0.25, y)]
    warm = paired_ms(calls, dev)
    maps = fmt.ordered_maps
    nbytes = (4 * nonzeros(A) + index_bytes(fmt, nonzeros(A))
              + maps.nbytes + 4 * k * (fmt.m + fmt.n))
    rec = {**entry(warm, (nbytes, 2 * nonzeros(A) * k)),
           "flushed_ms": flushed_ms(calls[0], dev), "gather_ms": warm[3],
           "vector_ms": warm[4], "vector_route_ms": warm[5],
           "slots": maps.slots, "blocks": fmt.idx.numel()}
    print(f"[8 timing mul_ordered, flagship mul_mat k={k}] {fmt.L} stripes, "
          f"{fmt.idx.numel()} blocks, {maps.slots} slots; kernel {warm[0] * 1e3:.2f} "
          f"us ({rec['flushed_ms'] * 1e3:.2f} L2-flushed), plain {warm[1] * 1e3:.2f} "
          f"us, library (CSR @ X) {warm[2] * 1e3:.2f} us, the gather on A.T's pack "
          f"{warm[3] * 1e3:.2f} us; bound {rec['bound_ms'] * 1e3:.2f} us "
          f"({rec['bound_by']}), {rec['bound_ms'] / warm[0]:.3f} of it; a vector "
          f"(alpha, beta, y) by block {warm[4] * 1e3:.2f} us, mul on the "
          f"{op.route_fw[0]} route {warm[5] * 1e3:.2f} us", flush=True)
    return rec


def phase_timing_above_l2(dev, errs):
    """The stripe kernel on ``blocky_matrix(**BLOCKY_ABOVE_L2)``: 16x the
    flagship's stripes, a call of ~250 MB that no L2 holds, built through
    the operator's entry point.  Held against the f64 product, its plain
    version and the library call first, then timed back-to-back (kernel,
    plain, library) and L2-flushed.  Returns the ``x16_*`` fields of the
    kernels line's ``tr_spmv`` entry."""
    t0 = time.perf_counter()
    A = blocky_matrix(**BLOCKY_ABOVE_L2)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    name, fmt, _ = op.route_tr
    check(name == "stripe" and op.row_perm is None,
          f"the large blocky matrix took the {name} route "
          f"(relabeled: {op.row_perm is not None})")
    rng = np.random.default_rng(15)
    x = rng.standard_normal(op.m).astype(np.float32)
    y = rng.standard_normal(op.n).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    AT = csr_of_transpose(A, dev)
    calls = [lambda: vt.tr_spmv(fmt, xt, 0.5, 0.25, yt),
             lambda: vt.tr_spmv_plain(fmt, xt, 0.5, 0.25, yt),
             lambda: torch.addmv(yt, AT, xt, beta=0.25, alpha=0.5)]
    got, ref = calls[0](), calls[1]()
    twice = calls[0]()
    torch.cuda.synchronize()
    want = 0.5 * (A.T @ x.astype(np.float64)) + 0.25 * y.astype(np.float64)
    got_np = got.cpu().numpy()
    e_p, e_o = rel_err(got_np, ref.cpu().numpy()), rel_err(got_np, want)
    check(got_np.shape == (op.n,) and np.isfinite(got_np).all()
          and e_p <= TOL and e_o <= TOL and torch.equal(got, twice),
          f"the large blocky matrix: kernel off by {e_p:.2e} (plain), "
          f"{e_o:.2e} (f64), or two launches differ")
    errs["tr_spmv"] = max(errs["tr_spmv"], float((got - ref).abs().max()))
    same_function("large blocky SpMV", calls[2], calls[0])
    warm = paired_ms(calls, dev)
    cold = [flushed_ms(c, dev) for c in calls]
    nnz = nonzeros(A)
    work = tr_spmv_work(fmt, nnz, True)
    rec, nbytes = entry(warm, work), work[0]
    cols = {"quad": "four columns a thread",
            "staged": "a run of stripes a block"}[thread_map(fmt)]
    print(f"[8 timing tr_spmv, blocky_matrix({BLOCKY_ABOVE_L2}): {op.m}x{op.n}, "
          f"nnz {nnz}, {fmt.L} stripes, {fmt.idx.numel()} blocks; generated in "
          f"{t_gen:.2f} s, from_csc (transposed, to device) {t_op:.2f} s] "
          f"kernel ({cols}) "
          f"{warm[0] * 1e3:.2f} us/call back-to-back, "
          f"{cold[0] * 1e3:.2f} us flushed ({nbytes / 1e6:.1f} MB per call: "
          f"{nbytes / (warm[0] * 1e6):.1f} GB/s back-to-back, "
          f"{nbytes / (cold[0] * 1e6):.1f} flushed; bound "
          f"{rec['bound_ms'] * 1e3:.2f} us, {rec['bound_ms'] / warm[0]:.3f} of it "
          f"back-to-back, {rec['bound_ms'] / cold[0]:.3f} flushed); plain "
          f"{warm[1] * 1e3:.2f} / {cold[1] * 1e3:.2f} us; library (torch.addmv, "
          f"CSR) {warm[2] * 1e3:.2f} / {cold[2] * 1e3:.2f} us; |Δ|/max "
          f"{e_p:.3e} (plain), {e_o:.3e} (f64); two launches bitwise equal",
          flush=True)
    return {"x16_ms": warm[0], "x16_flushed_ms": cold[0],
            "x16_bound_ms": rec["bound_ms"], "x16_plain_ms": warm[1],
            "x16_library_ms": warm[2], "x16_library_flushed_ms": cold[2]}


def cell_view(dev, label, reorder, want, errs, key):
    """One TrSpMV cell's packed direction (``stripe_ab.CELLS``), built
    from ``spbench/gen`` under ``reorder`` and held to the thread map
    ``want``: the route is the stripe kernel; after a reset, each checked
    call is one launch of that map and no other; the kernel against its
    plain version bare, with alpha/beta/y and into a longer ``out=``
    buffer through ``col_out`` (its other entries kept), two launches
    bitwise; then the cell's call timed back-to-back (kernel, plain) and
    L2-flushed.  The largest error goes to ``errs[key]``.  Returns (the
    cell's record, its launches)."""
    _, _, _, direction, (alpha, beta, with_y) = stripe_ab.CELLS[label]
    t0 = time.perf_counter()
    A = stripe_ab.cell_matrix(label)
    op = vt.VBCOperator.from_csc(A, W=8, directions=direction, reorder=reorder,
                                 device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    name, fmt, _ = op.route_tr if direction == "transposed" else op.route_fw
    view = "natural view" if op.perm_t is not None else "unpermuted pack"
    check(name == "stripe" and (fmt.col_out is not None) == (op.perm_t is not None)
          and (op.perm_t is None) == (reorder == "never") and thread_map(fmt) == want,
          f"{label} ({reorder}): route {name}, {view}, map {thread_map(fmt)} "
          f"(want the stripe route's {want} map)")
    rng = np.random.default_rng(21)
    xt = torch.from_numpy(rng.standard_normal(op.m).astype(np.float32)).to(dev)
    yt = torch.from_numpy(rng.standard_normal(op.n).astype(np.float32)).to(dev)
    big = torch.from_numpy(rng.standard_normal(2 * op.n + 1).astype(np.float32)).to(dev)
    place = torch.from_numpy(rng.permutation(2 * op.n + 1)[:op.n].astype(np.int32)).to(dev)
    placed = dataclasses.replace(
        fmt, col_out=place if fmt.col_out is None else place[fmt.col_out.long()])
    forms = {"bare": (fmt, (), False), "alpha_beta_y": (fmt, (0.5, 0.25, yt), False),
             "out": (placed, (0.5, 0.25, big), True)}
    worst, n_launch = 0.0, 0
    for form, (f, args, into) in forms.items():
        def run(kernel, f=f, args=args, into=into):
            return kernel(f, xt, *args, **({"out": torch.full_like(big, 7.0)}
                                            if into else {}))
        reset_launches()
        got, again = run(vt.tr_spmv), run(vt.tr_spmv)
        torch.cuda.synchronize()
        maps = maps_since_reset()
        check(maps == {**dict.fromkeys(maps, 0), want: 2}
              and vt.tr_spmv.launches == 2,
              f"{label} {form}: launches {maps} (want two "
              f"{want})")
        n_launch += 2
        ref = run(vt.tr_spmv_plain)
        err = rel_err(got.cpu().numpy(), ref.cpu().numpy())
        check(np.isfinite(err) and err <= TOL and torch.equal(got, again),
              f"{label} {form}: {want} map off the plain version by {err:.2e}, "
              f"or two launches differ")
        errs[key] = max(errs[key], float((got - ref).abs().max()))
        worst = max(worst, err)
        del got, again, ref
    call_args = () if alpha is None else (alpha, beta, yt)
    calls = [lambda: vt.tr_spmv(fmt, xt, *call_args),
             lambda: vt.tr_spmv_plain(fmt, xt, *call_args)]
    warm = paired_ms(calls, dev)
    cold = flushed_ms(calls[0], dev)
    nnz = nonzeros(A)
    work = tr_spmv_work(fmt, nnz, with_y)
    bound_ms, bound_by = bound(*work)
    rec = {"ms": warm[0], "flushed_ms": cold, "plain_ms": warm[1],
           "bound_ms": bound_ms, "bound_by": bound_by, "reorder": reorder,
           "map": want, "stripes": fmt.L, "blocks": fmt.idx.numel(),
           "runs": int(stage_plan(fmt).shape[0] - 1) if want == "staged" else None}
    runs = "" if rec["runs"] is None else f", {rec['runs']} runs"
    print(f"[8 timing tr_spmv, {want} map, {label}'s {view} (reorder={reorder!r}): "
          f"{op.m}x{op.n}, nnz {nnz}, {fmt.L} stripes of mean width "
          f"{op.n / fmt.L:.3f}, {fmt.idx.numel()} blocks{runs}; "
          f"generated and from_csc {t_op:.2f} s] kernel {warm[0] * 1e3:.2f} "
          f"us/call back-to-back, {cold * 1e3:.2f} flushed ({work[0] / 1e6:.1f} MB "
          f"per call; bound {bound_ms * 1e3:.2f} us, {bound_ms / warm[0]:.3f} of "
          f"it back-to-back); plain {warm[1] * 1e3:.2f} us; |Δ|/max {worst:.3e} "
          f"(plain; bare, alpha/beta/y, out=); two launches bitwise equal",
          flush=True)
    del op, fmt, placed, calls, xt, yt, big, place
    torch.cuda.empty_cache()
    return rec, n_launch


def phase_timing_cells(dev, errs):
    """The stripe kernel's staged map on the natural views of the
    benchmark's two TrSpMV cells' relabeled packs (``stripe_ab.CELLS``:
    ``blocky_w8``'s ``tr_mul(x, 1, 0.5, y)``, ``hpcg_27pt_144``'s
    ``mul(x)``; ``reorder="always"``: HPCG's cell relabels under auto-RCM
    too, ``blocky_w8``'s did under the earlier rule), each through
    :func:`cell_view`.  Returns (the kernels line's ``tr_spmv_staged``
    entry, its launches); the entry's ``ms``/``bound_ms`` are the blocky
    cell's, each cell's under ``cells``."""
    errs["tr_spmv_staged"] = 0.0
    cells, n_launch = {}, 0
    for label in stripe_ab.CELLS:
        cells[label], n = cell_view(dev, label, "always", "staged", errs,
                                    "tr_spmv_staged")
        n_launch += n
    first = cells[next(iter(stripe_ab.CELLS))]
    rec = {k: first[k] for k in ("ms", "flushed_ms", "plain_ms", "bound_ms", "bound_by")}
    rec["library_ms"] = None
    rec["cells"] = cells
    return rec, n_launch


def phase_timing_unpermuted(dev, errs):
    """The float4 map on the pack ``blocky_w8.trmul_stream`` runs under
    the port's auto-RCM rule, its unpermuted 8-wide stripes
    (``reorder="never"``, through :func:`cell_view`): the ``cells`` field
    of the kernels line's ``tr_spmv`` entry."""
    label = next(iter(stripe_ab.CELLS))
    rec, _ = cell_view(dev, label, "never", "quad", errs, "tr_spmv")
    return {label: rec}


def phase_timing_cells_f64(dev, errs):
    """The stripe kernel's f64 staged map on the natural view the
    benchmark's float64 cell runs (``stripe_ab.F64_CELLS``:
    ``hpcg_27pt_144_f64``'s ``mul(x)``), built as the cell builds it
    (``reorder="always"``: the relabeled pack auto-RCM keeps there).  The
    route is the stripe kernel on an f64 natural view; after a reset, each
    checked call is one ``staged_f64`` launch and no other; the kernel
    against its plain version in f64 (``TOL_F64``) bare, with alpha/beta/y
    and into a longer ``out=`` through ``col_out``, two launches bitwise;
    then the cell's call timed back-to-back (kernel, plain) and
    L2-flushed, its bound at 8 bytes an element (and f64 operations at
    half the f32 peak).  Returns (the kernels line's ``tr_spmv_staged_f64``
    entry, its launches)."""
    errs["tr_spmv_staged_f64"] = 0.0
    label, (_, _, _, direction, (alpha, beta, _)) = next(iter(stripe_ab.F64_CELLS.items()))
    t0 = time.perf_counter()
    A = stripe_ab.cell_matrix(label)
    op = vt.VBCOperator.from_csc(A, W=8, directions=direction, reorder="always", device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    name, fmt, _ = op.route_tr if direction == "transposed" else op.route_fw
    check(name == "stripe" and fmt.col_out is not None and fmt.val.dtype == torch.float64
          and thread_map(fmt) == "staged",
          f"{label}: route {name}, natural view {fmt.col_out is not None}, values "
          f"{fmt.val.dtype}, map {thread_map(fmt)} (want the f64 staged map on a "
          f"natural view)")
    rng = np.random.default_rng(21)
    xt = torch.from_numpy(rng.standard_normal(op.m)).to(dev)
    yt = torch.from_numpy(rng.standard_normal(op.n)).to(dev)
    big = torch.from_numpy(rng.standard_normal(2 * op.n + 1)).to(dev)
    place = torch.from_numpy(rng.permutation(2 * op.n + 1)[:op.n].astype(np.int32)).to(dev)
    placed = dataclasses.replace(fmt, col_out=place[fmt.col_out.long()])
    forms = {"bare": (fmt, (), False), "alpha_beta_y": (fmt, (0.5, 0.25, yt), False),
             "out": (placed, (0.5, 0.25, big), True)}
    worst, n_launch = 0.0, 0
    for form, (f, args, into) in forms.items():
        def run(kernel, f=f, args=args, into=into):
            return kernel(f, xt, *args, **({"out": torch.full_like(big, 7.0)}
                                            if into else {}))
        reset_launches()
        got, again = run(vt.tr_spmv), run(vt.tr_spmv)
        torch.cuda.synchronize()
        maps = maps_since_reset()
        check(maps == {**dict.fromkeys(maps, 0), "staged_f64": 2}
              and vt.tr_spmv.launches == 2,
              f"{label} {form}: launches {maps} (want two "
              f"staged_f64)")
        n_launch += 2
        ref = run(vt.tr_spmv_plain)
        err = rel_err(got.cpu().numpy(), ref.cpu().numpy())
        check(got.dtype == torch.float64 and np.isfinite(err) and err <= TOL_F64
              and torch.equal(got, again),
              f"{label} {form}: f64 staged map off the plain version by {err:.2e}, "
              f"or two launches differ")
        errs["tr_spmv_staged_f64"] = max(errs["tr_spmv_staged_f64"],
                                         float((got - ref).abs().max()))
        worst = max(worst, err)
        del got, again, ref
    call_args = () if alpha is None else (alpha, beta, yt)
    calls = [lambda: vt.tr_spmv(fmt, xt, *call_args),
             lambda: vt.tr_spmv_plain(fmt, xt, *call_args)]
    warm = paired_ms(calls, dev)
    cold = flushed_ms(calls[0], dev)
    nnz = nonzeros(A)
    nbytes, flops = tr_spmv_work(fmt, nnz, beta is not None, elem=8)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / (F32_FLOP_PER_S / 2) * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    runs = int(stage_plan(fmt).shape[0] - 1)
    print(f"[8 timing tr_spmv, f64 staged map, {label}'s natural view: {op.m}x{op.n}, "
          f"nnz {nnz}, {fmt.L} stripes of mean width {op.n / fmt.L:.3f}, "
          f"{fmt.idx.numel()} blocks, {runs} runs; generated and from_csc (RCM) "
          f"{t_op:.2f} s] kernel {warm[0] * 1e3:.2f} us/call back-to-back, "
          f"{cold * 1e3:.2f} flushed ({nbytes / 1e6:.1f} MB per call; bound "
          f"{bound_ms * 1e3:.2f} us, {bound_ms / warm[0]:.3f} of it back-to-back); "
          f"plain {warm[1] * 1e3:.2f} us; |Δ|/max {worst:.3e} (plain; bare, "
          f"alpha/beta/y, out=); two launches bitwise equal", flush=True)
    rec = {"ms": warm[0], "flushed_ms": cold, "plain_ms": warm[1], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "stripes": fmt.L,
           "blocks": fmt.idx.numel(), "runs": runs, "cell": label}
    del op, fmt, placed, calls, xt, yt, big, place
    torch.cuda.empty_cache()
    return rec, n_launch


def phase_timing_relabeled(dev, fem, scat, spmm):
    """The auto-RCM calls on the FEM and scattered operators, device and
    host wall, each beside the paths they replace, built from the same
    public pieces in this process: ``tr_mul(alpha, beta, y)`` (one launch
    on the natural view) against the composed path (gather x, the kernel
    on the relabeled pack, gather y, ``beta * y``, add: 5 launches) and
    the half-fused one (gather x, the kernel on the relabeled pack with
    ``col_out`` and beta: 2); ``tr_mul_mat`` at k=32 against
    ``index_select``, the SpMM on the relabeled pack, ``index_select``.
    Prints a ``RELABEL {...}`` line; returns its dict."""
    res = {}
    for label, (_, op, x, y), (alpha, beta) in (
            ("FEM", fem, (2.0, -0.5)), ("scattered", scat[:4], (0.5, 0.25))):
        name, _, call = op.route_tr
        perm, inv = op.perm_t, torch.argsort(op.perm_t).int()
        rel = (op.dev_tr if name == "stripe"
               else vt.ScatterDevice.from_host(op.host_tr, dev))
        half = dataclasses.replace(rel, col_out=perm)
        X = spmm[label][1]
        calls = [lambda: op.tr_mul(x, alpha, beta, y),
                 lambda: vt.gather(call(rel, vt.gather(x, perm), alpha), inv) + beta * y,
                 lambda: call(half, vt.gather(x, perm), alpha, beta, y),
                 lambda: op.tr_mul_mat(X),
                 lambda: vt.tr_spmm(op.dev_tr, X.index_select(0, perm)).index_select(0, inv)]
        for i, what in ((1, "composed"), (2, "half-fused"), (4, "composed SpMM")):
            same_function(f"{label} {what}", calls[i], calls[i - 1 if i < 4 else 3])
        warm = paired_ms(calls, dev)
        wall = [host_ms(c, dev) for c in calls]
        keys = ("tr_mul", "composed", "half_fused", "tr_mul_mat", "composed_mat")
        res[label] = {"route": name, "k": X.shape[1],
                      **{f"{k}_us": w * 1e3 for k, w in zip(keys, warm)},
                      **{f"{k}_wall_us": w * 1e3 for k, w in zip(keys, wall)}}
        print(f"[8 timing auto-RCM {label}, {name} route] device / host wall per "
              f"call: tr_mul(alpha, beta, y) {warm[0] * 1e3:.2f} / "
              f"{wall[0] * 1e3:.2f} us (1 launch), composed {warm[1] * 1e3:.2f} / "
              f"{wall[1] * 1e3:.2f} us (5), half-fused {warm[2] * 1e3:.2f} / "
              f"{wall[2] * 1e3:.2f} us (2); tr_mul_mat k={X.shape[1]} "
              f"{warm[3] * 1e3:.2f} / {wall[3] * 1e3:.2f} us, composed with "
              f"index_select {warm[4] * 1e3:.2f} / {wall[4] * 1e3:.2f} us; natural "
              f"view's own arrays {own_bytes(op.route_tr[1]) / 1e6:.2f} MB",
              flush=True)
    print("RELABEL " + json.dumps(res), flush=True)
    return res


def phase_chain_fold(dev, chains):
    """The auto-RCM FEM ``tr_mul_chain`` (one chain launch, its perm in a
    gather pass before the iterations and one after) bitwise against the
    composed path it replaced (gather x, the chain on the relabeled pack,
    gather y: three launches) at 5 iterations and ``CHAIN_ITERS`` (alpha
    1 / ||A||_1, so that the values stay finite), both timed in one
    ``paired_ms`` (device) and on the host clock at 5 iterations of that
    alpha and ``CHAIN_ITERS`` of ``CHAIN_ALPHA``.  Prints a ``CHAINFOLD
    {...}`` line."""
    _, op, xt, alpha = chains["FEM"]
    perm, inv = op.perm_t, torch.argsort(op.perm_t).int()
    rec = {}
    for n_it, a in ((5, alpha), (CHAIN_ITERS, CHAIN_ALPHA)):
        def pair(a, n_it=n_it):
            return [lambda: op.tr_mul_chain(xt, n_it, a),
                    lambda: vt.gather(vt.tr_spmv_chain(
                        op.dev_tr, vt.gather(xt, perm), n_it, a), inv)]
        folded, composed = pair(alpha)
        same_function(f"FEM chain x{n_it}, folded and composed", composed, folded,
                      tol=None)
        calls = pair(a)
        warm = paired_ms(calls, dev, iters=5)
        wall = [host_ms(c, dev) for c in calls]
        rec[f"x{n_it}"] = {"folded_us": warm[0] * 1e3, "composed_us": warm[1] * 1e3,
                           "folded_wall_us": wall[0] * 1e3,
                           "composed_wall_us": wall[1] * 1e3, "bitwise": True}
        print(f"[9 chain fold, FEM auto-RCM x{n_it}] tr_mul_chain (1 launch, "
              f"perm in the chain) {warm[0] * 1e3:.2f} us device / "
              f"{wall[0] * 1e3:.2f} us host wall; composed gather, chain, gather "
              f"(3 launches) {warm[1] * 1e3:.2f} / {wall[1] * 1e3:.2f} us; bitwise "
              f"equal", flush=True)
    print("CHAINFOLD " + json.dumps(rec), flush=True)
    return rec


def tile_lists(pack, dev, two_d):
    """The tile copy's inputs on the halo paths of ``pack`` at
    ``DIST_RANKS`` ranks, as each rank's ``StreamShard`` builds them:
    ``[(label, src, tiles)]``, the send lists on the rank's own tiles (x
    from seed 0) and, 2-D, the pools on a stage of the same length as the
    exchange leaves (its values those of the own tiles, repeated)."""
    ranges = shard.split_ranges(shard.stored_per_stripe(pack), DIST_RANKS)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(int(pack.m), device=dev, generator=g)
    out = []
    for d in range(DIST_RANKS):
        sh = stream.StreamShard(rank=d, ndev=DIST_RANKS, pack=pack,
                                ranges=ranges, device=dev)
        x_own = stream.own_x(sh, x)
        out.append((f"send {d}", x_own, sh.send_tiles))
        if two_d:
            stage = x_own.repeat(-(-sh.halo.stage_rows // x_own.numel()))
            out.append((f"pool {d}", stage[:sh.halo.stage_rows].contiguous(),
                        sh.pool_tiles))
    return out


def phase_timing_tiles(dev, flag, parts, errs):
    """The tile copy on the halo paths' own tile lists (phase 16's
    shapes): the flagship's send lists and 2-D (a)'s send lists and pools
    at ``DIST_RANKS`` ranks, each bitwise against its plain version and
    ``index_select`` on the tile view, and timed beside both; bound: 8
    bytes an element (one read, one write) and 4 a tile.  The kernels
    line's record is the flagship's rank 0 send list.  Prints a
    ``TILES {...}`` line; returns the record."""
    res, record = {}, None
    for label, pack, two_d in (("flagship", flag[1].host_tr, False),
                               ("2-D (a)", parts["a"][1].host_tr, True)):
        for what, src, tiles in tile_lists(pack, dev, two_d):
            def library(src=src, tiles=tiles):
                return src.view(-1, 1024).index_select(0, tiles).reshape(-1)
            same_function(f"{label} tile copy, {what}", library,
                          lambda: vt.gather_tiles(src, tiles), tol=None)
            got, plain = vt.gather_tiles(src, tiles), vt.gather_tiles_plain(src, tiles)
            check(torch.equal(got, plain), f"{label} tile copy, {what}: differs "
                                           f"from its plain version")
            errs["gather_tiles"] = max(errs["gather_tiles"],
                                       float((got - plain).abs().max()))
            warm = paired_ms([lambda: vt.gather_tiles(src, tiles),
                              lambda: vt.gather_tiles_plain(src, tiles), library], dev)
            n = tiles.numel()
            rec = entry(warm, (8 * 1024 * n + 4 * n, 0))
            res[f"{label} {what}"] = {"tiles": n, "us": warm[0] * 1e3,
                                      "plain_us": warm[1] * 1e3,
                                      "library_us": warm[2] * 1e3,
                                      "bound_us": rec["bound_ms"] * 1e3}
            if record is None:
                record = rec
    for key, r in res.items():
        print(f"[16 timing tile copy, {key}] {r['tiles']} tiles (grid {r['tiles']} "
              f"blocks of 256 threads): kernel {r['us']:.2f} us, plain "
              f"{r['plain_us']:.2f} us, library (index_select on the tile view) "
              f"{r['library_us']:.2f} us, bound {r['bound_us']:.4f} us; bitwise "
              f"equal", flush=True)
    print("TILES " + json.dumps(res), flush=True)
    return record


def own_bytes(view):
    """Bytes of a natural view's own array, its rows (``col_out`` is the
    operator's permutation; the rest it shares with the relabeled pack)."""
    rows = view.idx if isinstance(view, vt.VBC1DDevice) else view.row
    return 4 * rows.numel()


def chain_loops(fmt, AT, n_iters, alpha):
    """The chain's two yardsticks: ``n_iters`` launches of the stripe
    kernel, and ``n_iters`` library SpMV calls (``torch.addmv`` on the CSR
    of ``A.T``, beta 0)."""
    buf = torch.empty(fmt.n, dtype=torch.float32, device=fmt.device)

    def launches(x):
        for _ in range(n_iters):
            x = vt.tr_spmv(fmt, x, alpha)
        return x

    def library(x):
        for _ in range(n_iters):
            x = torch.addmv(buf, AT, x, beta=0.0, alpha=alpha)
        return x

    return launches, library


def phase_timing_slice4(dev, chains, scat, rel, pairs_2d):
    """The chain kernel at ``CHAIN_ITERS`` beside its plain version, the
    stripe-kernel launch loop and the library loop; the operators' chain
    end to end; the scatter kernel on the scattered matrix beside its plain
    version and the library SpMV; the scatter and stripe kernels on each
    of the six packs (the route's guard); the relayout."""
    out = {}
    n_it, a = CHAIN_ITERS, CHAIN_ALPHA
    A, op, xt, _ = chains["flagship"]
    fmt = op.dev_tr
    launches, library = chain_loops(fmt, csr_of_transpose(A, dev), n_it, a)
    alpha = chains["flagship"][3]  # bounded values for the comparison
    check_lib = chain_loops(fmt, csr_of_transpose(A, dev), 5, alpha)
    same_function("flagship chain", lambda: check_lib[1](xt),
                  lambda: vt.tr_spmv_chain(fmt, xt, 5, alpha))
    same_function("flagship chain launches", lambda: check_lib[0](xt),
                  lambda: vt.tr_spmv_chain(fmt, xt, 5, alpha))
    blocks, budget = chain_grid(dev)
    blocks0, _ = chain_grid(dev, 0)
    diag = vt.VBC1DDevice.from_host(vt.vbc1d(
        sp.identity(1024, np.float32, format="csc"), 8, vt.EquiChunker(8)), dev)
    xd = torch.ones(1024, device=dev)
    warm = paired_ms([lambda: vt.tr_spmv_chain(fmt, xt, n_it, a),
                      lambda: vt.tr_spmv_chain_plain(fmt, xt, n_it, a),
                      lambda: library(xt), lambda: launches(xt),
                      lambda: launch_chain(fmt, xt, n_it, a, blocks0, 0),
                      lambda: launch_chain(diag, xd, n_it, a, blocks, budget)],
                     dev, iters=5)
    out["tr_spmv_chain"] = entry(warm, tr_spmv_work(fmt, nonzeros(A), False, n_it))
    out["tr_spmv_chain"]["launch_loop_ms"] = warm[3]
    out["tr_spmv_chain"]["barrier_floor_ms"] = warm[5]
    A2, op2, xt2, _ = chains["FEM"]
    x2 = vt.gather(xt2, op2.perm_t)
    launches2, library2 = chain_loops(
        op2.dev_tr, csr_of_transpose(operator_matrix(A2, op2), dev), n_it, a)
    warm2 = paired_ms([lambda: vt.tr_spmv_chain(op2.dev_tr, x2, n_it, a),
                       lambda: library2(x2), lambda: launches2(x2),
                       lambda: launch_chain(op2.dev_tr, x2, n_it, a, blocks0, 0)],
                      dev, iters=5)
    e2e = paired_ms([lambda: op.tr_mul_chain(xt, n_it, a),
                     lambda: op2.tr_mul_chain(xt2, n_it, a)], dev, iters=5)
    wall = [host_ms(lambda: o.tr_mul_chain(x, n_it, a), dev)
            for o, x in ((op, xt), (op2, xt2))]
    res = {}
    for label, f in (("flagship", fmt), ("FEM", op2.dev_tr)):
        ranges, resident = chain_bytes(f, chain_plan(f, blocks, budget))
        res[label] = (int((resident == ranges).sum()),
                      float(resident.sum()) / max(1, float(ranges.sum())),
                      float(ranges.sum()) / 1e6)
    per_it = tr_spmv_work(fmt, nonzeros(A), False)[0]
    print(f"[8 timing chain x{n_it}, alpha {a}] grid {blocks} blocks of 1024 "
          f"threads at {budget} B of shared memory each ({blocks0} at budget 0); "
          + "; ".join(f"{k}: {v[0]} of {blocks} blocks hold their whole range, "
                      f"{v[1]:.4f} of the {v[2]:.2f} MB of values and block rows "
                      f"resident" for k, v in res.items())
          + f"; barrier floor (1024-column diagonal pack, full grid) "
          f"{warm[5] * 1e3:.2f} us/call ({warm[5] * 1e3 / n_it:.3f} us/iteration)",
          flush=True)
    print(f"[8 timing chain x{n_it}, alpha {a}] flagship: kernel "
          f"{warm[0] * 1e3:.2f} us/call ({warm[0] * 1e3 / n_it:.3f} us/iteration, "
          f"{A.nnz * n_it / (warm[0] * 1e6):.1f} Gnnz/s, "
          f"{per_it * n_it / (warm[0] * 1e6):.1f} GB/s of per-iteration "
          f"traffic), at budget 0 (streamed) {warm[4] * 1e3:.2f} us, "
          f"{n_it} stripe-kernel launches {warm[3] * 1e3:.2f} us, "
          f"library loop (torch.addmv, CSR) {warm[2] * 1e3:.2f} us, plain "
          f"{warm[1] * 1e3:.2f} us, bound {out['tr_spmv_chain']['bound_ms'] * 1e3:.2f}"
          f" us ({out['tr_spmv_chain']['bound_by']}); FEM (relabeled space): "
          f"kernel {warm2[0] * 1e3:.2f} us, at budget 0 {warm2[3] * 1e3:.2f} us, "
          f"launches {warm2[2] * 1e3:.2f} us, "
          f"library loop {warm2[1] * 1e3:.2f} us; tr_mul_chain end to end, device "
          f"/ host wall per call: flagship {e2e[0] * 1e3:.2f} / "
          f"{wall[0] * 1e3:.2f} us, FEM auto-RCM {e2e[1] * 1e3:.2f} / "
          f"{wall[1] * 1e3:.2f} us", flush=True)

    A3, op3, xt3, yt3, _, routes = scat
    _, fmt3, _ = op3.route_tr  # the natural view: natural x and y
    AT3 = csr_of_transpose(A3, dev)
    same_function("scattered SpMV",
                  lambda: torch.addmv(yt3, AT3, xt3, beta=0.25, alpha=0.5),
                  lambda: vt.tr_spmv_scatter(fmt3, xt3, 0.5, 0.25, yt3))
    warm = paired_ms([lambda: vt.tr_spmv_scatter(fmt3, xt3, 0.5, 0.25, yt3),
                      lambda: vt.tr_spmv_scatter_plain(fmt3, xt3, 0.5, 0.25, yt3),
                      lambda: torch.addmv(yt3, AT3, xt3, beta=0.25, alpha=0.5)],
                     dev)
    work = tr_spmv_work(fmt3, nonzeros(A3), True)
    out["tr_spmv_scatter"] = entry(warm, work)
    cold = flushed_ms(lambda: vt.tr_spmv_scatter(fmt3, xt3, 0.5, 0.25, yt3), dev)
    nbytes = work[0]
    print(f"[8 timing scatter, scattered A, {fmt3.row.numel()} entries, "
          f"{fmt3.tiles.n_tiles} tiles] kernel {warm[0] * 1e3:.2f} us/call warm "
          f"({nbytes / 1e6:.2f} MB, {nbytes / (warm[0] * 1e6):.1f} GB/s), "
          f"{cold * 1e3:.2f} us flushed; plain {warm[1] * 1e3:.2f} us, library "
          f"(torch.addmv, CSR) {warm[2] * 1e3:.2f} us, bound "
          f"{out['tr_spmv_scatter']['bound_ms'] * 1e3:.2f} us", flush=True)

    # the flagship's A.T (its mul), bare, and without its two longest columns
    Af, opf = chains["flagship"][0], chains["flagship"][1]
    name_f, fmt_f, _ = opf.route_fw
    check(name_f == "scatter", "the flagship's A.T is not on the scatter route")
    cut, longest = without_longest_columns(sp.csc_matrix(Af.T), 2)
    fmt_cut = vt.ScatterDevice.from_host(vt.vbc1d(cut, 8), dev)
    Acsr = csr_of_transpose(sp.csc_matrix(Af.T), dev)  # A itself, as CSR
    xf = torch.randn(fmt_f.m, device=dev)
    zero = torch.zeros(fmt_f.n, device=dev)
    same_function("flagship A.T SpMV", lambda: torch.addmv(zero, Acsr, xf, beta=0.0),
                  lambda: vt.tr_spmv_scatter(fmt_f, xf))
    warm_f = paired_ms([lambda: vt.tr_spmv_scatter(fmt_f, xf),
                        lambda: vt.tr_spmv_scatter_plain(fmt_f, xf),
                        lambda: torch.addmv(zero, Acsr, xf, beta=0.0),
                        lambda: vt.tr_spmv_scatter(fmt_cut, xf)], dev)
    cold_f = flushed_ms(lambda: vt.tr_spmv_scatter(fmt_f, xf), dev)
    rec_f = entry(warm_f[:3], tr_spmv_work(fmt_f, nonzeros(Af), False))
    out["tr_spmv_scatter"].update({f"flagship_at_{k}": v for k, v in rec_f.items()})
    out["tr_spmv_scatter"]["flagship_at_flushed_ms"] = cold_f
    cnt = torch.diff(fmt_f.colptr)
    print(f"[8 timing scatter, flagship A.T, {fmt_f.row.numel()} entries, "
          f"{fmt_f.tiles.n_tiles} tiles, {fmt_f.tiles.empty.numel()} empty "
          f"columns, {float(cnt.float().mean()):.2f} entries a column mean / "
          f"{int(cnt.max())} max] kernel {warm_f[0] * 1e3:.2f} us/call warm, "
          f"{cold_f * 1e3:.2f} us flushed; plain {warm_f[1] * 1e3:.2f} us, "
          f"library (torch.addmv, CSR) {warm_f[2] * 1e3:.2f} us, bound "
          f"{rec_f['bound_ms'] * 1e3:.2f} us ({rec_f['bound_by']}); without its "
          f"two longest columns ({longest} entries) {warm_f[3] * 1e3:.2f} us",
          flush=True)

    guard = {}
    g = torch.Generator(device=dev).manual_seed(14)
    for label, o in (("flagship", opf), ("FEM", op2), ("scattered", op3)):
        for direction, host, stripe, route in (
                ("A", o.host_tr, o.nat_tr, o.route_tr),
                ("A.T", o.host_fw, o.nat_fw, o.route_fw)):
            sc = route[1]
            if route[0] != "scatter":  # the scatter format in natural order
                sc = vt.ScatterDevice.from_host(host, dev)
                sc = sc if o.perm_t is None else sc.natural_view(o.perm_t)
            x = torch.randn(stripe.m, device=dev, generator=g)
            t_sc, t_st = paired_ms([lambda: vt.tr_spmv_scatter(sc, x),
                                    lambda: vt.tr_spmv(stripe, x)], dev)
            cnt = torch.diff(sc.colptr)
            key = f"{label} {direction}"
            guard[key] = {"mean_width": routes[key][0], "route": route[0],
                          "scatter_us": t_sc * 1e3, "stripe_us": t_st * 1e3}
            print(f"[8 guard {key}] mean stripe width {routes[key][0]:.3f}, "
                  f"entries per column {float(cnt.float().mean()):.2f} mean / "
                  f"{int(cnt.max())} max, {sc.tiles.n_tiles} tiles: "
                  f"scatter {t_sc * 1e3:.2f} us, stripe {t_st * 1e3:.2f} us, "
                  f"route {route[0]} "
                  f"({'the faster' if (t_sc <= t_st) == (route[0] == 'scatter') else 'the slower'})",
                  flush=True)
    one, two = guard_packs(dev)
    for key, r in one.items():
        faster = "scatter" if r["scatter_us"] <= r["stripe_us"] else "stripe"
        print(f"[8 guard {key}] mean stripe width {r['mean_width']:.3f}: scatter "
              f"{r['scatter_us']:.2f} us, stripe {r['stripe_us']:.2f} us, route "
              f"{r['route']} (the {'faster' if faster == r['route'] else 'slower'})",
              flush=True)
    pairs_2d = {**pairs_2d, **two}
    for key, r in pairs_2d.items():
        faster = "tile2d" if r["tile2d_us"] <= r["view_us"] else "view"
        print(f"[8 guard {key}] mean tile height {r['mean_tile_height']:.3f}, "
              f"{r['stored']} stored values: tile kernel {r['tile2d_us']:.2f} us, "
              f"stripe kernel on the 1-D view {r['view_us']:.2f} us, route "
              f"{r['route']} (the {'faster' if faster == r['route'] else 'slower'})",
              flush=True)
    print("GUARD " + json.dumps({
        "max_mean_width": MAX_MEAN_WIDTH, "packs": {**guard, **one},
        "tile2d_min_height": TILE2D_MIN_HEIGHT, "packs_2d": pairs_2d}),
        flush=True)

    x, R = rel
    xpad = torch.zeros(R * 1024, device=dev)
    xpad[: x.numel()] = x
    same_function("relayout",
                  lambda: xpad.view(R, 8, 128).transpose(0, 1).reshape(8, R * 128),
                  lambda: vt.tile_relayout(x, R), tol=None)
    warm = paired_ms([lambda: vt.tile_relayout(x, R),
                      lambda: vt.tile_relayout_plain(x, R),
                      lambda: xpad.view(R, 8, 128).transpose(0, 1).reshape(8, R * 128)],
                     dev)
    out["tile_relayout"] = entry(warm, (4 * x.numel() + 4 * R * 1024, 0))
    print(f"[8 timing relayout R={R}] kernel {warm[0] * 1e3:.2f} us/call, plain "
          f"{warm[1] * 1e3:.2f} us, library (view/transpose/reshape of the "
          f"padded x) {warm[2] * 1e3:.2f} us, bound "
          f"{out['tile_relayout']['bound_ms'] * 1e3:.2f} us", flush=True)
    return out


def phase_probes(dev, floor_ms):
    """12: the five probes through their entry points (each module's
    ``run``, what ``python -m vbcs_tpu_torch.probes.probe_<name>`` runs),
    between a reset and a read of the probe kernels' launch counts; then
    every variant of the four probe kernels against its plain version at
    full size (gathers bitwise, sums to ``TOL``), each kernel's record for
    the kernels line, and the chain probe's marginal iterations beside the
    chain's barrier floor of phase 8 (``floor_ms`` a 100-iteration call)
    and the streaming design's (``STREAMING_CHAIN_US``)."""
    t_phase = time.perf_counter()
    sp4 = probe_spmm4.inputs().to(dev)  # built once: 83M normal draws
    for k in PROBES:
        k.launches = 0
    t0 = time.perf_counter()
    launch = probe_launch.run(dev)
    pk = probe_kernel.run(dev)
    pk2 = probe_kernel2.run(dev)
    chains = probe_chain.run(dev, floor_ms / CHAIN_ITERS)
    spmm4 = probe_spmm4.run(dev, inp=sp4)
    t_run = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in PROBES}
    check(all(launches.values()), f"a probe kernel was not launched: {launches}")
    print(f"[12 probes] five probes in {t_run:.1f} s; probe kernel launches "
          f"{launches}", flush=True)
    probe_launch.print_record(launch, dev)
    probe_chunk.print_records(pk + pk2, dev)
    probe_chain.print_records(chains, dev)
    probe_spmm4.print_record(spmm4, dev)
    floor_us = floor_ms * 1e3 / CHAIN_ITERS
    print(f"[12 probes] chain probe, marginal us an iteration (beside the chain "
          f"kernel's barrier floor of phase 8, {floor_us:.3f} us, and the streaming "
          f"design's, PERF.md row 16): "
          + ", ".join(f"{r['variant']} {r['ms'] * 1e3:.3f} ({r['ms'] * 1e3 / floor_us:.2f}"
                      f"x the floor; streaming {STREAMING_CHAIN_US[r['variant']]:.2f})"
                      for r in chains)
          + f"; grid {probe_chain.grid(dev, 'B')[0]} blocks at "
          f"{probe_chain.grid(dev, 'B')[1]} B of shared memory each; tiny launch a "
          f"step: eager {launch['one']['wall_ms'] * 1e3:.2f}"
          f" us (caller's clock), graph {launch['one']['graph_ms'] * 1e3:.2f} us "
          f"(device); add_one through "
          f"ctypes {launch['add_one']['wall_ms'] * 1e3:.2f} us, tr_spmv on one "
          f"stripe {launch['tr_spmv_one_stripe']['wall_ms'] * 1e3:.2f} us on the "
          f"caller's clock", flush=True)

    # every variant against its plain version (not counted: after the read)
    errs = dict.fromkeys(launches, 0.0)
    x = torch.randn(8, 128, device=dev)
    got = probe_launch.add_one(x)
    check(torch.equal(got, probe_launch.add_one_plain(x)), "add_one differs from plain")
    n_chunk = 0
    built = {}
    for probe in (probe_kernel, probe_kernel2):
        for var, kw in dict.fromkeys((v, tuple(kw.items()))
                                     for _, v, kw in probe.VARIANTS):
            if (probe, kw) not in built:
                built[probe, kw] = probe.inputs(**dict(kw)).to(dev)
            inp = built[probe, kw]
            got, want = probe_chunk.chunk(var, inp), probe_chunk.chunk_plain(var, inp)
            torch.cuda.synchronize()
            e = rel_err(got.cpu().numpy(), want.cpu().numpy())
            check(got.shape == want.shape and bool(torch.isfinite(got).all())
                  and (torch.equal(got, want) if var in probe_chunk.BITWISE
                       else e <= TOL),
                  f"{probe.__name__} {var} {kw}: kernel off its plain version "
                  f"by {e:.2e}")
            errs["chunk"] = max(errs["chunk"], float((got - want).abs().max()))
            n_chunk += 1
    worst_chain = 0.0
    for _, var, wblk in probe_chain.VARIANTS:
        inp = probe_chain.inputs(wblk=wblk).to(dev)
        for n in (1, 2, 3):
            got = probe_chain.chain(var, inp, n)
            want = probe_chain.chain_plain(var, inp, n)
            e = rel_err(got.cpu().numpy(), want.cpu().numpy())
            check(bool(torch.isfinite(got).all()) and e <= TOL,
                  f"probe chain {var} x{n}: off its plain version by {e:.2e}")
            worst_chain = max(worst_chain, e)
            errs["chain"] = max(errs["chain"], float((got - want).abs().max()))
    got, want = probe_spmm4.fma(sp4.Xg, sp4.Vl), probe_spmm4.fma_plain(sp4.Xg, sp4.Vl)
    e_fma = rel_err(got.cpu().numpy(), want.cpu().numpy())
    check(e_fma <= TOL, f"probe spmm4 FMA off its plain version by {e_fma:.2e}")
    errs["fma"] = float((got - want).abs().max())
    same_function("probe spmm4 FMA", lambda: probe_spmm4.fma_library(sp4.Xg, sp4.Vl),
                  lambda: probe_spmm4.fma(sp4.Xg, sp4.Vl))
    same_function("probe add_one", lambda: torch.add(x, 1.0),
                  lambda: probe_launch.add_one(x), tol=None)
    print(f"[12 probes, kernels against plain] add_one bitwise; chunk: {n_chunk} "
          f"variants at T = 39, gathers bitwise, worst |Δ| {errs['chunk']:.3e}; "
          f"chain probe A-D x1-3 at T = 40: worst |Δ|/max {worst_chain:.3e}; "
          f"spmm4 FMA at T = 157: {e_fma:.3e} (tol {TOL})", flush=True)

    # the kernels line: the full v3 chunk (probe_kernel2 d), the chain
    # probe's full body (B) an iteration, the FMA
    # the chunk's library yardstick: torch.addmv on the sparse matrix a
    # *_red variant applies to x (probe_kernel2 d, row 15; probe_kernel 4,
    # row 14)
    inp = built[probe_kernel2, ()]
    inp4 = built[probe_kernel, ()]
    libs = {}
    for var, i in (("take2_red", inp), ("ladder_red", inp4)):
        M = probe_chunk.library_matrix(var, i)
        xf, z = i.x.reshape(-1), torch.zeros(M.shape[0], device=dev)
        libs[var] = lambda M=M, xf=xf, z=z: torch.addmv(z, M, xf, beta=0.0)
        same_function(f"probe chunk {var}",
                      lambda var=var, i=i: libs[var]().view(8, -1),
                      lambda var=var, i=i: probe_chunk.chunk(var, i))
    d = paired_ms([lambda: probe_chunk.chunk("take2_red", inp),
                   lambda: probe_chunk.chunk_plain("take2_red", inp),
                   libs["take2_red"]], dev)
    d4 = paired_ms([lambda: probe_chunk.chunk("ladder_red", inp4),
                    lambda: probe_chunk.chunk_plain("ladder_red", inp4),
                    libs["ladder_red"]], dev)
    # the chain probe's library yardstick: an iteration of its full body
    # (B) as torch.addmv on the CSR of the matrix it applies to x
    b_inp = probe_chain.inputs().to(dev)
    plain_it = marginal_ms(lambda n: probe_chain.chain_plain("B", b_inp, n), 1, 4,
                           dev, iters=1)
    Mb = probe_chain.library_matrix("B", b_inp)
    xb, zb = b_inp.xin.reshape(-1), torch.zeros(Mb.shape[0], device=dev)
    lib_b = lambda: torch.addmv(zb, Mb, xb, beta=0.0, alpha=0.999)  # noqa: E731
    same_function("probe chain B, an iteration", lambda: lib_b().view(probe_chain.W, -1),
                  lambda: probe_chain.chain_plain("B", b_inp, 1))
    lib_it = paired_ms([lib_b], dev)[0]
    fma_plain = paired_ms([lambda: probe_spmm4.fma_plain(sp4.Xg, sp4.Vl)], dev,
                          iters=3)[0]
    a = launch["add_one"]
    b = next(r for r in chains if r["variant"] == "B")
    ms = {
        "add_one": entry([a["ms"], a["plain_ms"], a["library_ms"]], (a["bytes"], 0)),
        "chunk": {**entry(d, (probe_chunk.needed_bytes("take2_red", inp),
                              2 * inp.val.numel())),
                  **{f"ladder_red_{key}": v for key, v in entry(
                      d4, (probe_chunk.needed_bytes("ladder_red", inp4),
                           2 * inp4.val.numel())).items()}},
        "chain": {**entry([b["ms"], plain_it, lib_it], (b["bytes"], b["flops"])),
                  "barrier_floor_ms": b["barrier_floor_ms"]},
        "fma": entry([spmm4["fma_ms"], fma_plain, spmm4["library_ms"]],
                     (spmm4["fma_bytes"], spmm4["fma_flops"])),
    }
    print(f"[12 probes, records] chunk (probe_kernel2 d) {d[0] * 1e3:.2f} us, plain "
          f"{d[1] * 1e3:.2f} us, library (torch.addmv, CSR) {d[2] * 1e3:.2f} us; "
          f"probe_kernel 4 {d4[0] * 1e3:.2f} us, plain {d4[1] * 1e3:.2f} us, library "
          f"{d4[2] * 1e3:.2f} us; chain probe B plain {plain_it * 1e3:.2f} us an "
          f"iteration, library (torch.addmv, CSR) {lib_it * 1e3:.2f} us an "
          f"iteration; FMA plain {fma_plain * 1e3:.2f} us; phase 12 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, errs, ms


# ---- slice 8: the semirings, the autotuner, the guards' packs, the table

SEMI_TOL = 1e-10  # f64 semiring route against scipy's f64 product
# the phase's fits, at the JAX package's default working set (its sizing
# counts the TPU's padded stream: the port's calls move less, see the
# AUTOTUNE line's "bytes a call")
AUTOTUNE_1D = dict(W=8, target_bytes=64 << 20)
AUTOTUNE_2D = dict(U=4, W=4, target_bytes=64 << 20, rank=3)
L2_BYTES = 50 << 20  # the H100's L2
ABOVE_L2 = 8  # the 1-D sample's stripes times this: a call's bytes above the L2
GUARD_WIDTHS = (2, 3, 4)  # 1-D packs of uniform stripe width, at the flagship's size
GUARD_HEIGHTS = (1, 2, 4, 8)  # 2-D packs of uniform tile height, w = 8,
# each of the flagship's ~2.56M stored values


@contextlib.contextmanager
def counting_semiring():
    """Counts the calls of ``ops/semiring.py``'s functions that the
    operators make inside the block: yields a one-item list."""
    calls = [0]

    def counting(fn):
        def wrapped(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(semiring, "tr_spmv", counting(semiring.tr_spmv)), \
            mock.patch.object(semiring, "tr_spmm", counting(semiring.tr_spmm)):
        yield calls


def f32_alpha(A) -> float:
    """1 / ||A||_1 rounded to f32: the chain's alpha, exact in both the
    semiring loop (which rounds alpha to f32, as the JAX loop does) and
    the f64 oracle."""
    return float(np.float32(1.0 / abs(sp.csc_matrix(A)).sum(axis=0).max()))


def semiring_f64_run(label, A32, dev, rng, relabeled):
    """An f64 operator of ``A32`` at full size: ``tr_mul(alpha, beta, y)``
    and ``mul`` (the stripe kernel's f64 map: one ``staged_f64`` launch
    each), ``tr_mul_mat``/``mul_mat`` at k=32 and ``tr_mul_chain`` x5 (the
    semiring route) against scipy's f64 products (``SEMI_TOL``); returns
    the matrix, the operator and its f64 x and y on the card."""
    A = sp.csc_matrix(A32, dtype=np.float64)
    t0 = time.perf_counter()
    op = vt.VBCOperator.from_csc(A, W=8, device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    check(op.dev_tr.val.dtype == op.dev_fw.val.dtype == torch.float64,
          f"{label}: an f64 operator's kernel formats are not f64")
    check((op.row_perm is not None) == relabeled,
          f"{label}: auto-RCM {'did not relabel' if relabeled else 'relabeled'} "
          f"the f64 matrix")
    m, n = A.shape
    x, y, xf = rng.standard_normal(m), rng.standard_normal(n), rng.standard_normal(n)
    X, Xf = rng.standard_normal((m, 32)), rng.standard_normal((n, 32))
    alpha = f32_alpha(A)
    xt, yt, xft, Xt, Xft = (torch.from_numpy(a).to(dev) for a in (x, y, xf, X, Xf))
    before = trace.launches_by_map()["staged_f64"]
    got = {"tr_mul": op.tr_mul(xt, 0.5, 0.25, yt), "mul": op.mul(xft)}
    f64_map = trace.launches_by_map()["staged_f64"] - before
    got.update({"tr_mul_mat": op.tr_mul_mat(Xt), "mul_mat": op.mul_mat(Xft),
                "tr_mul_chain": op.tr_mul_chain(xt, 5, alpha)})
    torch.cuda.synchronize()
    check(f64_map == 2, f"{label}: f64 tr_mul and mul launched {f64_map} f64 staged "
                        f"maps (want 2)")
    want = {"tr_mul": 0.5 * (A.T @ x) + 0.25 * y, "mul": A @ xf,
            "tr_mul_mat": A.T @ X, "mul_mat": A @ Xf,
            "tr_mul_chain": chain_oracle(A, x, 5, alpha)}
    errs = {}
    for k, t in got.items():
        check(t.dtype == torch.float64 and tuple(t.shape) == want[k].shape
              and bool(torch.isfinite(t).all()),
              f"{label} f64 {k}: wrong dtype, shape or non-finite values")
        errs[k] = rel_err(t.cpu().numpy(), want[k])
        check(errs[k] <= SEMI_TOL, f"{label} f64 {k} off scipy's f64 product by "
                                   f"{errs[k]:.2e}")
    order = "relabeled by RCM" if op.row_perm is not None else "natural order"
    print(f"[13 semiring f64 {label}] {m}x{n}, {A.nnz} nnz, {order}, "
          f"{op.semi_tr.val.numel()} stored values; from_csc {t_op:.3f} s; "
          f"tr_mul/mul on the f64 staged map, the rest semiring; "
          f"|Δ|/max vs scipy f64: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol {SEMI_TOL}; SpMM k=32, chain x5 at alpha {alpha:.6g})",
          flush=True)
    return A, op, xt, yt


def semiring_exact(dev, rng):
    """``Pajek/GD99_c`` as an int32 matrix (values in [-5, 5]) and as a
    bool matrix, through both operators: every call exact against the
    int64 product (int32 x and X; alpha and beta integers), the bool
    matrix also with an f32 x; a bool x raises ``TypeError``."""
    A_bool = sp.csc_matrix(dict(corpus())["Pajek/GD99_c"] != 0)
    A_int = A_bool.astype(np.int32)
    A_int.data = rng.integers(-5, 6, A_int.nnz).astype(np.int32)
    m, n = A_bool.shape
    x = rng.integers(-5, 6, m).astype(np.int32)
    y = rng.integers(-5, 6, n).astype(np.int32)
    xf = rng.integers(-5, 6, n).astype(np.int32)
    X = rng.integers(-5, 6, (m, 7)).astype(np.int32)
    Xf = rng.integers(-5, 6, (n, 7)).astype(np.int32)
    xt, yt, xft, Xt, Xft = (torch.from_numpy(a).to(dev) for a in (x, y, xf, X, Xf))
    n_checks = 0
    for kind, A in (("int32", A_int), ("bool", A_bool)):
        Ai = A.astype(np.int64)
        want = {"tr_mul": 2 * (Ai.T @ x) + 3 * y.astype(np.int64),
                "mul": Ai @ xf, "tr_mul_mat": Ai.T @ X, "mul_mat": Ai @ Xf,
                "tr_mul f32 x": Ai.T @ x}
        for shape, op in (("1-D", vt.VBCOperator.from_csc(A, W=8, device=dev)),
                          ("2-D", vt.VBC2DOperator.from_csc(A, 4, 4, device=dev))):
            got = {"tr_mul": op.tr_mul(xt, 2, 3, yt), "mul": op.mul(xft),
                   "tr_mul_mat": op.tr_mul_mat(Xt), "mul_mat": op.mul_mat(Xft),
                   "tr_mul f32 x": op.tr_mul(xt.float())}
            for k, t in got.items():
                dtype = torch.float32 if "f32" in k else torch.int32
                check(t.dtype == dtype and np.array_equal(
                    t.cpu().numpy().astype(np.int64), want[k]),
                    f"GD99_c {kind} {shape} {k}: not exact")
                n_checks += 1
            try:
                op.tr_mul(xt.bool())
            except TypeError:
                n_checks += 1
            else:
                raise RuntimeError(f"GD99_c {kind} {shape}: a bool x did not raise")
    print(f"[13 semiring exact] Pajek/GD99_c {m}x{n}, int32 (values in [-5, 5]) "
          f"and bool matrices, VBCOperator and VBC2DOperator: {n_checks} checks "
          f"exact (int32 x, X and y; alpha 2, beta 3; the bool matrix also with "
          f"an f32 x) or raising TypeError (a bool x)", flush=True)


def phase_semiring(dev, flag):
    """13: the non-f32 routes at full size — the flagship and the
    auto-RCM FEM as f64 operators (``tr_mul``/``mul`` on the stripe
    kernel's f64 map, the SpMM and the chain on ``ops/semiring.py``),
    GD99_c as int32 and bool — and their times beside the f32 kernel, the
    library call and the CSC baseline (``ops/csr.py``).  Returns the
    SEMIRING record."""
    rng = np.random.default_rng(16)
    with counting_semiring() as calls:
        A64, op64, x64, y64 = semiring_f64_run("flagship", flag[0], dev, rng, False)
        semiring_f64_run("FEM", fem_matrix(k=320), dev, rng, True)
        semiring_exact(dev, rng)
    check(calls[0] > 0, "the non-f32 calls did not reach ops/semiring.py")

    A32, op32, xt, yt = flag
    AT64 = csr_of_transpose(A64, dev, np.float64)
    AT32 = csr_of_transpose(A32, dev)
    op_int = vt.VBCOperator.from_host(dataclasses.replace(
        op64.host_tr, val=op64.host_tr.val.astype(np.int32)), None, None, dev)
    xi = torch.from_numpy(rng.integers(-5, 6, op_int.m).astype(np.int32)).to(dev)
    C = vt.CSC.from_scipy(A32)
    csc32 = vt.CSCDevice.from_host(C, dtype=np.float32, device=dev)
    csc64 = vt.CSCDevice.from_host(C, dtype=np.float64, device=dev)
    same_function("f64 flagship SpMV",
                  lambda: torch.addmv(y64, AT64, x64, beta=0.25, alpha=0.5),
                  lambda: op64.tr_mul(x64, 0.5, 0.25, y64), tol=SEMI_TOL)
    same_function("CSC baseline f32", lambda: torch.mv(AT32, xt),
                  lambda: vt.csc_tr_spmv(csc32, xt))
    same_function("CSC baseline f64", lambda: torch.mv(AT64, x64),
                  lambda: vt.csc_tr_spmv(csc64, x64), tol=SEMI_TOL)
    calls = {
        "f64 tr_mul(alpha, beta, y)": lambda: op64.tr_mul(x64, 0.5, 0.25, y64),
        "f32 tr_mul(alpha, beta, y)": lambda: op32.tr_mul(xt, 0.5, 0.25, yt),
        "f64 library (torch.addmv, CSR)": lambda: torch.addmv(
            y64, AT64, x64, beta=0.25, alpha=0.5),
        "int32 tr_mul": lambda: op_int.tr_mul(xi),
        "CSC baseline f32": lambda: vt.csc_tr_spmv(csc32, xt),
        "f32 library (torch.mv, CSR)": lambda: torch.mv(AT32, xt),
        "CSC baseline f64": lambda: vt.csc_tr_spmv(csc64, x64),
        "f64 library (torch.mv, CSR)": lambda: torch.mv(AT64, x64),
    }
    warm = dict(zip(calls, paired_ms(list(calls.values()), dev)))
    wall = {k: host_ms(calls[k], dev) for k in list(calls)[:2]}
    rec = {"flagship_us": {k: v * 1e3 for k, v in warm.items()},
           "flagship_wall_us": {k: v * 1e3 for k, v in wall.items()},
           "stored_values_f64": int(op64.semi_tr.val.numel()), "nnz": int(A32.nnz)}
    print(f"[13 semiring timing, flagship] device us/call (host wall): "
          + ", ".join(f"{k} {v * 1e3:.2f}" + (f" ({wall[k] * 1e3:.2f})" if k in wall
                                                 else "")
                      for k, v in warm.items()), flush=True)
    print("SEMIRING " + json.dumps(rec), flush=True)
    return rec


def phase_autotune(dev, flag):
    """14: the autotuned time models on the card at cut sizes (1-D at
    W=8, 2-D at U=W=4) into a fresh cache under ``build/``; the tables,
    the fit's relative residual with and without the excess-group column
    E and with a per-call constant, one sample warm against L2-flushed,
    and p/m (predicted over measured) of the min-memory and min-time
    plans on the flagship and the RCM'd FEM.  Returns the two models and
    the AUTOTUNE record."""
    t_phase = time.perf_counter()
    cache = os.path.join(ROOT, "build", "autotune_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["VBCS_CACHE"] = cache
    t0 = time.perf_counter()
    alpha, beta, gamma = autotune.autotune_1dvbc_trspmv(**AUTOTUNE_1D, device=dev)
    t_1d = time.perf_counter() - t0
    with open(autotune.cache_path_1d(**AUTOTUNE_1D, device=dev)) as fh:
        data = json.load(fh)["data"]
    fits = {}
    for name, (with_E, with_const) in (("L, q, E", (True, False)),
                                       ("L, q", (False, False)),
                                       ("L, q, E, const", (True, True)),
                                       ("L, q, const", (False, True))):
        _, _, _, const, resid = autotune.fit_1d(data, 8, with_E, with_const)
        fits[name] = {"resid": resid, "const_us": const / 1e3}
    t0 = time.perf_counter()
    tables2 = autotune.autotune_vbc_trspmv(**AUTOTUNE_2D, device=dev)
    t_2d = time.perf_counter() - t0
    with open(autotune.cache_path_2d(AUTOTUNE_2D["U"], AUTOTUNE_2D["W"],
                                     target_bytes=AUTOTUNE_2D["target_bytes"],
                                     device=dev)) as fh:
        data2 = json.load(fh)["data"]
    beta2 = sum(np.outer(r, c) for r, c in zip(tables2[2], tables2[3]))
    mdl = autotune.model_1dvbc_trspmv_time(**AUTOTUNE_1D, require_cache=True,
                                           device=dev)
    mdl2 = autotune.model_vbc_trspmv_time(**AUTOTUNE_2D, device=dev)

    # samples warm (as the fit times them) and L2-flushed: the 1-D fit's
    # first (w = 8 at full L), the same family at ABOVE_L2 times its
    # stripes (a call's bytes above the L2), with the model's prediction,
    # and the 2-D fit's largest (u = w = 4 at full L)
    W, tb = AUTOTUNE_1D["W"], AUTOTUNE_1D["target_bytes"]
    L0 = max(2048, int(tb / (8 * (8 * W * 4 + 36) + 2 * W * 4)))
    samples = {}
    for label, L in (("1-D w=8, the fit's", L0), (f"1-D w=8, x{ABOVE_L2}",
                                                   L0 * ABOVE_L2)):
        C = vt.CSC.from_scipy(autotune._synth(L, W, 8, 400, seed=W * 7 + 2))
        Phi = vt.pack_stripe(C, vt.EquiChunker(W))
        samples[label] = (vt.route_tr_spmv(vt.pack_1dvbc(C, Phi, W), dev),
                          vt.total_value(C, Phi, mdl) / 1e3)
    u, w, K, L, d, seed = next(autotune._synth2d_specs(
        AUTOTUNE_2D["U"], AUTOTUNE_2D["W"], 8, AUTOTUNE_2D["target_bytes"], True))
    C2 = vt.CSC.from_scipy(autotune._synth2d(K, u, L, w, d, 400, seed))
    B2 = vt.pack_vbc2d(C2, vt.SplitPartition.equi(C2.m, u),
                       vt.SplitPartition.equi(C2.n, w),
                       AUTOTUNE_2D["U"], AUTOTUNE_2D["W"])
    samples["2-D u=w=4, the fit's"] = (
        vt.route_tr_spmv_2d(B2, dev),
        (vt.total_value(C2, B2.Phi, mdl2, Pi=B2.Pi)
         + vt.row_component_value(B2.Pi, mdl2)) / 1e3)
    sample = {}
    for label, ((kname, fmt, call), pred) in samples.items():
        x = torch.randn(fmt.m, device=dev)
        y = torch.zeros(fmt.n, device=dev)
        nbytes = autotune._call_bytes(fmt)
        warm = autotune._chain_s(call, fmt, dev, nbytes)
        check(warm is not None, f"autotune sample {label}: no plausible reading")
        cold = flushed_ms(lambda: call(fmt, x, 1.0, 0.5, y), dev) * 1e-3
        sample[label] = {"route": kname, "stored": int(fmt.val.numel()),
                         "bytes": nbytes, "above_l2": nbytes > L2_BYTES,
                         "warm_us": warm * 1e6, "flushed_us": cold * 1e6,
                         "pred_us": pred, "p_over_m_warm": pred / (warm * 1e6),
                         "p_over_m_flushed": pred / (cold * 1e6)}
    del samples

    # p/m of the min-memory and min-time plans
    fem = vt.CSC.from_scipy(fem_matrix(k=320).astype(np.float32))
    pm = {}
    for label, C in (("flagship", vt.CSC.from_scipy(flag[0])),
                     ("FEM RCM'd", vt.rcm_symmetric(fem)[0])):
        for plan, planner in (("min memory", vt.default_1d_partitioner(8, 4)),
                              ("min time", vt.DynamicTotalChunker(mdl, 8))):
            Phi = vt.pack_stripe(C, planner)
            Bp = vt.pack_1dvbc(C, Phi, 8)
            kname, fmt, call = vt.route_tr_spmv(Bp, dev)
            t = autotune._chain_s(call, fmt, dev, autotune._call_bytes(fmt))
            pred = vt.total_value(C, Phi, mdl) / 1e3
            pm[f"{label} {plan}"] = {
                "route": kname, "L": Bp.L, "blocks": Bp.num_blocks,
                "mean_width": float(np.diff(Phi.spl).mean()),
                "measured_us": t * 1e6, "pred_us": pred, "p_over_m": pred / (t * 1e6)}
    rec = {"target_bytes_1d": tb, "target_bytes_2d": AUTOTUNE_2D["target_bytes"],
           "seconds_1d": t_1d, "seconds_2d": t_2d,
           "seconds": time.perf_counter() - t_phase,
           "samples_1d": len(data["ts"]), "samples_2d": len(data2["ts"]),
           "routes_1d": {k: data["kernels"].count(k) for k in set(data["kernels"])},
           "routes_2d": {k: data2["kernels"].count(k) for k in set(data2["kernels"])},
           "alpha_ns": alpha.tolist(), "beta_ns": beta.tolist(),
           "gamma_ns": gamma.tolist(), "fits": fits,
           "alpha_row_ns": tables2[0].tolist(), "alpha_col_ns": tables2[1].tolist(),
           "beta_2d_ns": beta2.tolist(), "sample": sample, "p_over_m": pm}
    print(f"[14 autotune] 1-D W=8 at target_bytes {tb} ({tb >> 20} MB): "
          f"{rec['samples_1d']} samples {rec['routes_1d']} in {t_1d:.1f} s; alpha ns "
          f"{np.round(alpha, 1).tolist()}, beta ns {np.round(beta, 2).tolist()}, "
          f"gamma ns {np.round(gamma, 2).tolist()}; relative residual (rms): "
          + ", ".join(f"[{k}] {v['resid']:.4f}" for k, v in fits.items())
          + f", per-call constant {fits['L, q, const']['const_us']:.2f} us "
          f"(without E)", flush=True)
    print(f"[14 autotune] 2-D U=W=4 at target_bytes {AUTOTUNE_2D['target_bytes']} "
          f"({AUTOTUNE_2D['target_bytes'] >> 20} MB): {rec['samples_2d']} samples "
          f"{rec['routes_2d']} in {t_2d:.1f} s; alpha_row ns "
          f"{np.round(tables2[0], 1).tolist()}, alpha_col ns "
          f"{np.round(tables2[1], 1).tolist()}, beta[u, w] ns (rank 3) "
          f"{np.round(beta2, 2).tolist()}", flush=True)
    print("[14 autotune] samples warm / L2-flushed (L2 "
          f"{L2_BYTES >> 20} MB): "
          + "; ".join(f"{k} [{v['route']}, {v['stored']} stored values, "
                      f"{v['bytes'] / 1e6:.2f} MB a call, "
                      f"{'above' if v['above_l2'] else 'inside'} the L2] warm "
                      f"{v['warm_us']:.2f} us, flushed {v['flushed_us']:.2f} us, "
                      f"predicted {v['pred_us']:.2f} us, p/m "
                      f"{v['p_over_m_warm']:.3f} / {v['p_over_m_flushed']:.3f}"
                      for k, v in sample.items()), flush=True)
    print("[14 autotune] p/m: "
          + "; ".join(f"{k} [{v['route']}, mean width {v['mean_width']:.3f}] "
                      f"measured {v['measured_us']:.2f} us, predicted "
                      f"{v['pred_us']:.2f} us, p/m {v['p_over_m']:.3f}"
                      for k, v in pm.items())
          + f"; phase 14 in {rec['seconds']:.1f} s", flush=True)
    print("AUTOTUNE " + json.dumps(rec), flush=True)
    return mdl, mdl2, rec


def guard_packs(dev):
    """The guards' extra packs, timed on both candidate kernels: 1-D packs
    of uniform stripe width ``GUARD_WIDTHS`` at the flagship's size
    (``autotune._synth``: scatter against stripe), and 2-D packs of
    uniform tile height ``GUARD_HEIGHTS`` at w = 8 and the flagship's
    number of stored values (``autotune._synth2d`` with 40,000 / u
    stripes: the tile kernel against the stripe kernel on the 1-D view).
    Returns (1-D records, 2-D records)."""
    one, two = {}, {}
    for w in GUARD_WIDTHS:
        B = vt.vbc1d(autotune._synth(320_000 // w, w, 8, 400, seed=40 + w), 8,
                     vt.EquiChunker(w))
        sc = vt.ScatterDevice.from_host(B, dev)
        st = vt.VBC1DDevice.from_host(B, dev)
        x = torch.randn(st.m, device=dev)
        t_sc, t_st = paired_ms([lambda: vt.tr_spmv_scatter(sc, x),
                                lambda: vt.tr_spmv(st, x)], dev)
        one[f"uniform w={w}"] = {
            "mean_width": float(w),
            "route": "scatter" if scatter_admits(B) else "stripe",
            "scatter_us": t_sc * 1e3, "stripe_us": t_st * 1e3}
    for u in GUARD_HEIGHTS:
        L, w = 40_000 // u, 8
        A = autotune._synth2d(L * w // u, u, L, w, 8, 400, seed=50 + u)
        C = vt.CSC.from_scipy(A)
        B2 = vt.pack_vbc2d(C, vt.SplitPartition.equi(C.m, u),
                           vt.SplitPartition.equi(C.n, w), 8, 8)
        fmt = vt.VBC2DDevice.from_host(B2, dev)
        view = fmt.view_1d()
        x = torch.randn(fmt.m, device=dev)
        y = torch.randn(fmt.n, device=dev)
        t_tile, t_view = paired_ms([lambda: vt.tr_spmv_2d(fmt, x, 0.5, 0.25, y),
                                    lambda: vt.tr_spmv(view, x, 0.5, 0.25, y)], dev)
        two[f"uniform u={u}"] = {
            "mean_tile_height": vt.mean_tile_height(B2),
            "route": vt.route_tr_spmv_2d(B2, dev, fmt)[0],
            "tile2d_us": t_tile * 1e3, "view_us": t_view * 1e3,
            "stored": int(fmt.val.numel())}
    return one, two


def phase_table(dev, flag, mdl, mdl2):
    """15: the method table (``vbcs_tpu_torch.tools.method_table``) on the
    flagship with the AUTOTUNE phase's models, each row's y checked
    against the f64 product.  Returns the TABLE record."""
    rows = method_table.build_table(
        flag[0], 8, device=dev, mdl_time=mdl, mdl_time2=mdl2,
        log=lambda line: print(f"[15 table] {line}", flush=True))
    check(len(rows) == 10, f"the table has {len(rows)} rows, not 10")
    rec = [{k: (None if isinstance(v, float) and not np.isfinite(v) else v)
            for k, v in dict(dataclasses.asdict(r), p_over_m=r.p_over_m).items()}
           for r in rows]
    print("TABLE " + json.dumps(rec), flush=True)
    return rec


DIST_RANKS = 4  # gloo ranks sharing the card (NCCL refuses two on one card)
DIST_REPS = 20  # timed calls of each vector path on each rank (host wall)
DIST_MAT_REPS = 3  # of each k = 128 SpMM path (gloo moves ~41 MB a rank a call)
DIST_K = 128
# the kernels each distributed path launches on every rank with columns:
# one of each set (spmv and spmm: none, the semiring route); the halo
# paths' tile copies are the tiles sent and (2-D) the pool
DIST_KERNELS = {"tr_spmv": [{"tr_spmv", "tr_spmv_scatter"}], "tr_spmm": [{"tr_spmm"}],
                "spmv": [], "spmm": [], "replicated": [{"tr_spmv"}],
                "halo": [{"tr_spmv"}, {"gather_tiles"}],
                "overlap": [{"tr_spmv"}, {"gather_tiles"}],
                "stripes": [{"tr_spmv"}], "2d": [{"tr_spmv_2d"}],
                "2d_halo": [{"tr_spmv_2d"}, {"gather_tiles"}]}
# the tile copies a call of a halo path makes on every rank with columns
# (the send; 2-D also the pool); no element gather on any path
DIST_TILE_COPIES = {"halo": 1, "overlap": 1, "2d_halo": 2}


def straddle_ranks_pack():
    """A 4,096 x 16 matrix of four 4 x 4 tiles, one a stripe, under a row
    partition offset by 2: each tile crosses an aligned 1,024-row boundary,
    which at 4 ranks (one x tile each) is a boundary between two ranks'
    x; stripes 0, 2 and 3 read both halves from other ranks."""
    dense = np.zeros((4096, 16), np.float32)
    rng = np.random.default_rng(6)
    for s, r0 in enumerate((3070, 2046, 1022, 1022)):
        dense[r0:r0 + 4, 4 * s:4 * s + 4] = rng.standard_normal((4, 4))
    Pi = vt.SplitPartition(np.concatenate([[0], np.arange(2, 4096, 4), [4096]]))
    return vt.pack_vbc2d(vt.CSC.from_scipy(sp.csc_matrix(dense)), Pi,
                         vt.SplitPartition(np.arange(0, 17, 4)), 4, 4)


def dist_jobs(dev, flag, parts):
    """The DIST phase's jobs (``vbcs_tpu_torch.entry.rank_paths``), each
    with its f64 product and the single-device result on the card:
    ``[(label, job, want, single)]``."""
    A, op = flag[0], flag[1]
    A2, op2 = parts["a"][0], parts["a"][1]
    S = straddle_ranks_pack()
    sdev = vt.VBC2DDevice.from_host(S, dev)
    m, n = op.m, op.n
    vec = {"reps": DIST_REPS}
    mat = {"reps": DIST_MAT_REPS}
    specs = [("flagship", "tr_spmv", op.host_tr, 11, (m,), vec, A.T, op.tr_mul),
             ("flagship", "spmv", op.host_tr, 12, (n,), vec, A, op.mul),
             ("flagship", "tr_spmm", op.host_tr, 13, (m, DIST_K), mat, A.T,
              op.tr_mul_mat),
             ("flagship", "spmm", op.host_tr, 14, (n, DIST_K), mat, A, op.mul_mat)]
    specs += [("flagship", p, op.host_tr, 11, (m,), vec, A.T, op.tr_mul)
              for p in ("replicated", "halo", "overlap", "stripes")]
    specs += [("blocky2d", p, op2.host_tr, 15, (op2.m,), vec, A2.T, op2.tr_mul)
              for p in ("2d", "2d_halo")]
    specs += [("straddle", p, S, 16, (S.m,), vec, sp.csc_matrix(S.to_dense()).T,
               lambda x: vt.tr_spmv_2d(sdev, x)) for p in ("2d", "2d_halo")]
    out = []
    for label, path, B, seed, shape, extra, AT, single in specs:
        job = {"path": path, "name": f"{label} {path}", "B": B, "seed": seed,
               "shape": shape, **extra}
        x = vt_entry.operand(job, dev)
        y1 = single(x)
        torch.cuda.synchronize()
        out.append((job["name"], job, AT.astype(np.float64) @ x.cpu().numpy()
                    .astype(np.float64), y1.cpu().numpy()))
    return out


def dist_world(backend, world, device, jobs, errs):
    """One world's run of the jobs, checked: each rank 0 ``y`` within TOL
    of its f64 product and of the single-device result (bitwise noted),
    each path's kernels on every rank within TOL of their plain versions
    on the same inputs (the largest |Δ| folded into ``errs``), each path's
    launches of the kernels it runs on every rank, every flagship rank
    with local stripes and fewer halo tiles than its own.  Returns
    (record, launches summed over ranks and paths)."""
    t0 = time.perf_counter()
    ranks = comm.run_ranks(vt_entry.rank_paths, world, backend, device,
                           [job for _, job, _, _ in jobs])
    seconds = time.perf_counter() - t0
    launches = {}
    paths = {}
    for i, (name, job, want, single) in enumerate(jobs):
        recs = [r[i] for r in ranks]
        y = recs[0]["y"]
        check(y.shape == want.shape and np.isfinite(y).all(),
              f"DIST {backend} {name}: wrong shape or non-finite values")
        err, vs = rel_err(y, want), rel_err(y, single)
        check(job["path"] not in DIST_TILE_COPIES or np.array_equal(y, single),
              f"DIST {backend} {name}: y is not bitwise the single-device y")
        check(err <= TOL and vs <= TOL,
              f"DIST {backend} {name}: |Δ|/max {err:.2e} against f64, {vs:.2e} "
              f"against the single-device result (tolerance {TOL})")
        groups = DIST_KERNELS[job["path"]]
        allowed = set().union(*groups)
        names = {k for r in recs for k in r["launches"]}
        check(names <= allowed and all(
            r["stats"]["columns"] == 0 or all(g & set(r["launches"]) for g in groups)
            for r in recs),
              f"DIST {backend} {name}: launches {[r['launches'] for r in recs]}, "
              f"want one of each of {groups or 'none'} on every rank with columns")
        want_tiles = DIST_TILE_COPIES.get(job["path"], 0)
        check(all(r["launches"].get("gather_tiles", 0) == want_tiles
                  and "gather" not in r["launches"]
                  for r in recs if r["stats"]["columns"]),
              f"DIST {backend} {name}: tile copies and gathers a rank "
              f"{[r['launches'] for r in recs]}, want {want_tiles} tile "
              f"copies and no gather on every rank with columns")
        check({k for r in recs for k in r["plain"]} == names,
              f"DIST {backend} {name}: kernels held against their plain "
              f"versions {[sorted(r['plain']) for r in recs]}, launched {names}")
        plain = {}
        for r in recs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for k, (diff, rel) in r["plain"].items():
                check(rel <= TOL, f"DIST {backend} {name}: {k} {rel:.2e} off its "
                      f"plain version on the same inputs (tolerance {TOL})")
                errs[k] = max(errs[k], diff)
                plain[k] = max(plain.get(k, 0.0), rel)
        paths[name] = {
            "wall_ms": max(r["wall_ms"] for r in recs),
            "kernel_ms": [r["kernel_ms"] for r in recs],
            "err_f64": err, "err_single": vs, "err_plain": plain,
            "bitwise_single": bool(np.array_equal(y, single)),
            "launches": [r["launches"] for r in recs]}
    by_path = {job["name"]: [r[i]["stats"] for r in ranks]
               for i, (_, job, _, _) in enumerate(jobs)}
    flag = by_path["flagship overlap"]
    check(all(s["local"] > 0 for s in flag),
          f"DIST {backend}: a flagship rank has no local stripe: {flag}")
    check(all(s["received"] < s["tiles_per_dev"] for s in flag),
          f"DIST {backend}: a flagship rank's halo is not below its own tiles: {flag}")
    rank_rows = [dict(s, kernel_ms={job["path"]: paths[name]["kernel_ms"][d]
                                     for name, job, _, _ in jobs
                                     if job["name"].startswith("flagship")})
                 for d, s in enumerate(flag)]
    return {"world": world, "device": str(device), "seconds": seconds,
            "host_copies": list(comm.HOST_COPIES[backend]),
            "flagship_ranks": rank_rows, "paths": paths}, launches


def phase_dist(dev, flag, parts, smi, errs):
    """16: the distributed paths (``vbcs_tpu_torch.parallel``) at full
    width: the flagship through ``parallel/spmv.py``'s four calls (SpMM at
    k = 128), the replicated, halo and overlapped-halo stream paths and the
    column-stripe path; ``blocky2d_matrix()`` (equi U=4, W=8) and a pack
    whose tiles straddle two ranks' x through the 2-D replicated and halo
    paths; in a world of ``DIST_RANKS`` gloo ranks sharing the card and a
    world of one NCCL rank.  Each result against its f64 product and the
    single-device result, each kernel against its plain version on the
    path's inputs; then ``entry()`` and ``dryrun_multichip(4,
    backend="gloo")``.  Prints a ``DIST {...}`` line; returns the
    launches of the kernels, summed over the worlds' ranks."""
    t_phase = time.perf_counter()
    jobs = dist_jobs(dev, flag, parts)
    rec = {"card": smi,
           "note": f"gloo: {DIST_RANKS} ranks sharing one H100 over gloo (no "
                   f"interconnect figure; host_copies: the collectives whose "
                   f"CUDA tensors the backend copies through host memory, "
                   f"comm.py stages none itself); nccl: a world of one rank"}
    launches = {}
    for backend, world, device in (("gloo", DIST_RANKS, "cuda:0"),
                                   ("nccl", 1, "cuda")):
        rec[backend], got = dist_world(backend, world, device, jobs, errs)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        for name, p in rec[backend]["paths"].items():
            us = [None if t is None else {k: round(v * 1e3, 2) for k, v in t.items()}
                  for t in p["kernel_ms"]]
            plain = {k: f"{v:.1e}" for k, v in p["err_plain"].items()}
            print(f"[16 dist {backend} x{world}] {name}: host wall "
                  f"{p['wall_ms'] * 1e3:.1f} us, kernels {us} us a rank, "
                  f"|Δ|/max {p['err_f64']:.2e} (f64), {p['err_single']:.2e} (one "
                  f"device, bitwise {p['bitwise_single']}), against plain {plain}",
                  flush=True)
            tiles_us = [t["gather_tiles"] * 1e3 for t in p["kernel_ms"]
                        if t and "gather_tiles" in t]
            if tiles_us:
                print(f"[16 dist {backend} x{world}] {name}: all its gathers (tile "
                      f"copies) a call {min(tiles_us):.2f}-{max(tiles_us):.2f} us "
                      f"over the ranks, host wall {p['wall_ms'] * 1e3:.1f} us",
                      flush=True)
    fn, args = vt_entry.entry(dev)
    A, _ = vt_entry._flagship()
    y = fn(*args)
    torch.cuda.synchronize()
    e_entry = rel_err(y.cpu().numpy(), A.T.astype(np.float64)
                      @ args[1].cpu().numpy().astype(np.float64))
    check(e_entry <= TOL, f"entry(): |Δ|/max {e_entry:.2e}")
    t0 = time.perf_counter()
    dry = vt_entry.dryrun_multichip(DIST_RANKS, backend="gloo")
    rec["dryrun"] = {"seconds": time.perf_counter() - t0,
                     "local": [s["local"] for s in dry["overlap"]["stats"]],
                     "err": {k: v["err"] for k, v in dry.items()}}
    rec["entry_err"] = e_entry
    rec["seconds"] = time.perf_counter() - t_phase
    print("DIST " + json.dumps(rec), flush=True)
    return launches


# ---- slice 10: the split-point DP on the card, the pack stages, weak scaling

DP_CUT = 4096  # the first columns of each matrix, where the kernels are held bitwise
DP_KERNELS = (dp_ops.dp_table, dp_ops.dp_recurrence_serial, dp_ops.dp_recurrence_scan,
              dp_ops.dp_recurrence_checked)
# H100 SXM data sheet: f64 outside the tensor cores (the DP's type)
F64_FLOP_PER_S = 34e12
WEAK_L0 = 1000  # stripes a rank in the weak-scaling rows
WEAK_REPS = 3
# N = 1 and 2: each N is a world of its own, and a world's start-up, not
# its rows, is the cost (phase 16 runs the 4-rank gloo world)
WEAK_WORLD = 2
DP_WIDE = 16  # past the serial fold's register ring (W <= 8): its plain loop
DP_CORRUPT = 97  # every 97th pointer of a corrupted guess moved to another width


def dp_cases(flag, fem, mdl, mdl2):
    """Phase 17's plans, ``(label, CSC, model, W, Pi)``: the memory models
    (integer tables) and phase 14's fitted time models (fractional), 1-D
    on the flagship and the scrambled FEM, 2-D on ``blocky2d_matrix()`` and
    the flagship (the 2-D time model was fit at U = W = 4: W = 4 and
    tiles of 4 rows); last, the flagship's 1-D memory plan at
    ``DP_WIDE``."""
    F, Fe = vt.CSC.from_scipy(flag[0]), vt.CSC.from_scipy(fem[0])
    B2 = vt.CSC.from_scipy(blocky2d_matrix())
    mem1, mem2 = vt.model_1dvbc_memory(4, 8), vt.model_vbc_memory(4, 8)
    equi = vt.SplitPartition.equi
    return [("flagship 1-D memory", F, mem1, 8, None),
            ("FEM 1-D memory", Fe, mem1, 8, None),
            ("blocky2d 2-D memory", B2, mem2, 8, equi(B2.m, 4)),
            ("flagship 2-D memory", F, mem2, 8, equi(F.m, 8)),
            ("flagship 1-D time", F, mdl, 8, None),
            ("FEM 1-D time", Fe, mdl, 8, None),
            ("blocky2d 2-D time", B2, mdl2, 4, equi(B2.m, 4)),
            ("flagship 2-D time", F, mdl2, 4, equi(F.m, 4)),
            (f"flagship 1-D memory W={DP_WIDE}", F, mem1, DP_WIDE, None)]


def device_plan(C, model, W, Pi, dev):
    """The entry point a user calls for the case: ``dp_partition_device``
    (1-D) or ``dp_partition_device_2d``."""
    if Pi is None:
        return vt.dp_partition_device(C, model, W, device=dev)
    return vt.dp_partition_device_2d(C, model, W, Pi, device=dev)


def csc_cut(C, k):
    """The first ``k`` columns of ``C``."""
    k = min(k, C.n)
    q = int(C.pos[k])
    return vt.CSC(C.m, k, C.pos[:k + 1], C.idx[:q], C.val[:q])


def dp_work(pos, wts, W):
    """((bytes, f64 operations) of the table, of the recurrence) on these
    inputs: each input read once and S, opt and prev written once; the
    table's counter updates (each nonzero, once for every window holding
    its column), suffix sums and stripe costs, the recurrence's add and
    compare per candidate (the serial fold's count: the least work of the
    function, whichever kernel computes it)."""
    p = pos.cpu().numpy()
    n, nnz = p.size - 1, int(p[-1])
    R = 1 if wts is None else wts.shape[0]
    jp = np.arange(1, n + 1)
    window_nnz = int((p[jp] - p[np.maximum(jp - W, 0)]).sum())
    table_bytes = 8 * (n + 1) + 8 * nnz + 8 * W * (1 + R) + 8 * n * W
    if wts is not None:
        table_bytes += 8 * nnz + 8 * wts.numel()
    table_ops = R * (2 * window_nnz + 3 * n * W)
    return (table_bytes, table_ops), (8 * n * W + 16 * (n + 1), 2 * n * W)


def bound64(nbytes, ops):
    """(bound_ms, bound_by) of f64 work: bytes over the memory rate, f64
    operations over the data sheet's f64 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_passes_ms(inputs, W, dev):
    """Device ms of each pass of ``dp_prev`` on ``inputs`` (CUDA events,
    the second of two runs), the recurrence on the inputs' route."""
    pos, grp, wts, alpha, beta, exact = inputs
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        prevcol = dp_ops.prev_occurrence(pos, grp)
        ev[1].record()
        S = dp_ops.dp_table(pos, grp, prevcol, wts, alpha, beta, W)
        ev[2].record()
        dp_ops.dp_recurrence(S, exact)
        ev[3].record()
        torch.cuda.synchronize()
    return {"prev_occurrence": ev[0].elapsed_time(ev[1]),
            "dp_table": ev[1].elapsed_time(ev[2]),
            "recurrence": ev[2].elapsed_time(ev[3])}


def corrupt_guess(guess, W, every=DP_CORRUPT):
    """``guess`` with every ``every``-th back pointer moved to another valid
    width (``jp - guess[jp]`` cycled within ``1 .. min(W, jp)``), which must
    make the checked fold restart."""
    g = guess.clone()
    if every >= g.numel():
        return g
    jp = torch.arange(every, g.numel(), every, device=g.device)
    lo = jp - jp.clamp(max=W)
    span = jp - lo
    g[jp] = torch.where(span > 1, lo + (g[jp] - lo + 1) % span, g[jp])
    return g


def checked_against(label, S, want, dev):
    """The checked fold on ``S`` with the scan's guess and a corrupted one,
    each bitwise its plain version (prev, opt and counters) and ``want``
    (the serial fold's prev and opt); the corrupted guess must restart.
    Returns the counters of both and the largest |Δ| of opt."""
    guess = dp_ops.dp_recurrence_scan(S)[0]
    out, err = {}, 0.0
    for name, g in (("scan", guess), ("corrupted", corrupt_guess(guess, S.shape[1]))):
        got = dp_ops.dp_recurrence_checked(S, g)
        plain = dp_ops.dp_recurrence_checked_plain(S, g)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"{label}: dp_recurrence_checked differs from its plain version "
              f"({name} guess)")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{label}: dp_recurrence_checked differs from the serial fold "
              f"({name} guess)")
        out[name] = dict(zip(("restarts", "rewalked", "folded"), got[2].tolist()))
        err = max(err, float((got[1] - plain[1]).abs().max()))
    check(out["corrupted"]["restarts"] > 0,
          f"{label}: the corrupted guess made no restart: {out}")
    return out, err


def dp_against_plain(label, C, model, W, Pi, dev):
    """The four kernels against their plain versions on the first
    ``DP_CUT`` columns: S, and opt and prev of the serial fold, the scan and
    the checked fold, bitwise (the scan follows its plain version's order
    of sums, so this holds on fractional tables too); on exact tables the
    scan also equal to the serial fold; the checked fold equal to the
    serial fold on every table, with the scan's guess and a corrupted one.
    Returns the largest |Δ| of each and the checked fold's counters."""
    pos, grp, wts, alpha, beta, exact = dp_inputs(csc_cut(C, DP_CUT), model, W,
                                                  Pi, device=dev)
    prevcol = dp_ops.prev_occurrence(pos, grp)
    S = dp_ops.dp_table(pos, grp, prevcol, wts, alpha, beta, W)
    S_plain = dp_ops.dp_table_plain(pos, grp, prevcol, wts, alpha, beta, W)
    prev, opt = dp_ops.dp_recurrence_serial(S)
    prev_plain, opt_plain = dp_ops.dp_recurrence_plain(S_plain)
    scan_prev, scan_opt = dp_ops.dp_recurrence_scan(S)
    scan_prev_plain, scan_opt_plain = dp_ops.dp_recurrence_scan_plain(S_plain)
    torch.cuda.synchronize()
    check(torch.equal(S, S_plain), f"{label}: dp_table differs from its plain version")
    check(torch.equal(opt, opt_plain) and torch.equal(prev, prev_plain),
          f"{label}: dp_recurrence_serial differs from its plain version")
    check(torch.equal(scan_opt, scan_opt_plain) and torch.equal(scan_prev, scan_prev_plain),
          f"{label}: dp_recurrence_scan differs from its plain version")
    check(not exact or (torch.equal(scan_opt, opt) and torch.equal(scan_prev, prev)),
          f"{label}: on exact tables the scan differs from the serial fold")
    counts, checked_err = checked_against(label, S, (prev, opt), dev)
    finite = torch.isfinite(S_plain)
    return {"dp_table": float((S - S_plain)[finite].abs().max()),
            "dp_recurrence_serial": float((opt - opt_plain).abs().max()),
            "dp_recurrence_scan": float((scan_opt - scan_opt_plain).abs().max()),
            "dp_recurrence_checked": checked_err}, counts


def recurrence_record(label, S, dev):
    """The scan on the whole matrix (exact tables): its device ms, its plain
    version's (host clock) and the result against the plain version and the
    serial fold (bitwise)."""
    kern, plain = dp_ops.dp_recurrence_scan, dp_ops.dp_recurrence_scan_plain
    got = kern(S)
    t = paired_ms([lambda: kern(S)], dev, iters=3)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(S)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: dp_recurrence_scan differs from its plain version")
    check(torch.equal(got[0], dp_ops.dp_recurrence_serial(S)[0]),
          f"{label}: the scan differs from the serial fold")
    return {"ms": t, "plain_ms": plain_ms, "plain_clock": "host",
            "library_ms": None}


def host_clock_ms(fn):
    """Host ms of one call of ``fn`` (a plain version), ended by a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def fold_records(label, S, dev, serial_plain=True):
    """The checked fold and the serial fold on a whole ``S``: each bitwise
    the other and its plain version with the scan's guess and a corrupted
    one; in one ``paired_ms``, in turns, the checked fold alone on the
    scan's guess (its ``ms``), with the scan (the route, ``route_ms``) and
    on the corrupted guess (``corrupted_ms``), the scan alone
    (``scan_ms``) and the serial fold; the plain versions on the host
    clock.  Returns (checked record, serial record, counters)."""
    guess = dp_ops.dp_recurrence_scan(S)[0]
    bad = corrupt_guess(guess, S.shape[1])
    serial = dp_ops.dp_recurrence_serial(S)
    counts, _ = checked_against(label, S, serial, dev)
    t_alone, t_route, t_bad, t_scan, t_serial = paired_ms(
        [lambda: dp_ops.dp_recurrence_checked(S, guess),
         lambda: dp_ops.dp_recurrence_checked(S),
         lambda: dp_ops.dp_recurrence_checked(S, bad),
         lambda: dp_ops.dp_recurrence_scan(S),
         lambda: dp_ops.dp_recurrence_serial(S)], dev, iters=3)
    checked = {"ms": t_alone, "route_ms": t_route, "corrupted_ms": t_bad,
               "scan_ms": t_scan, "library_ms": None,
               "plain_ms": host_clock_ms(
                   lambda: dp_ops.dp_recurrence_checked_plain(S, guess)),
               "plain_clock": "host"}
    ser = {"ms": t_serial, "library_ms": None, "plain_clock": "host",
           "plain_ms": (host_clock_ms(lambda: dp_ops.dp_recurrence_plain(S))
                        if serial_plain else None)}
    return checked, ser, counts


def fitted_1d(W, seed=0):
    """A 1-D model with fractional tables from ``seed``, like a fitted time
    model."""
    rng = np.random.default_rng(seed)
    return vt.ColumnBlockComponentCostModel(
        alpha_col=np.cumsum(rng.uniform(0.1, 1.3, W)) * 0.37,
        beta_col=np.cumsum(rng.uniform(0.01, 0.2, W)) * 0.29)


def table_of(C, model, W, Pi, dev):
    """S of ``C`` under ``model`` on the card."""
    pos, grp, wts, alpha, beta, _ = dp_inputs(C, model, W, Pi, device=dev)
    return dp_ops.dp_table(pos, grp, dp_ops.prev_occurrence(pos, grp), wts,
                           alpha, beta, W)


def phase_plan(dev, flag, fem, mdl, mdl2, smi, errs):
    """17: the split-point DP on the card (``dp_partition_device``,
    ``dp_partition_device_2d``) on the cases of :func:`dp_cases`, each
    plan's split points against the host C++ DP's and its launches (the
    table once; the scan once, and on fitted tables the checked fold once on
    the scan's guess; the serial fold never), the host ms of each stage of
    the plan and the checked fold's restarts (``dp_stages``), the four
    kernels against their plain versions on the first ``DP_CUT`` columns
    (bitwise; the checked fold with the scan's guess and a corrupted one,
    against the serial fold too), the device time of each pass (CUDA events)
    beside the device plan's host wall and the host DP's; the table and the
    scan (flagship, memory, W = 8, and ``DP_WIDE``) on the whole matrix
    against their plain versions, timed; the checked fold beside the serial
    fold in one ``paired_ms`` on the flagship's time plan, on its memory
    plan's S at ``DP_WIDE`` (the route forced to the checked fold) and on a
    fractional ``fitted_1d`` table at ``DP_WIDE``, each bitwise with both
    guesses; the serial fold beside its dependent floor; then
    ``probe_pack`` (all stages) and the weak-scaling rows at ``WEAK_L0`` up
    to ``WEAK_WORLD`` ranks.  Prints ``PLAN``, ``PACK`` and ``WEAK`` lines;
    returns the DP kernels' launches on the plans and their timing
    records."""
    t_phase = time.perf_counter()
    cases = dp_cases(flag, fem, mdl, mdl2)
    launches = {k.__name__: 0 for k in DP_KERNELS}
    routes = {}
    for label, C, model, W, Pi in cases:
        for k in DP_KERNELS:
            k.launches = 0
        got = device_plan(C, model, W, Pi, dev)
        counts = {k.__name__: k.launches for k in DP_KERNELS}
        routes[label] = route = dp_route(C, model, W, Pi)
        want = dp_partition(C, model, W, row_partition=Pi)
        check(np.array_equal(got.spl, want.spl),
              f"{label}: the device DP's split points differ from the host DP's")
        want_counts = {"dp_table": 1, "dp_recurrence_serial": 0,
                       "dp_recurrence_scan": 1,
                       "dp_recurrence_checked": int(route == "checked")}
        check(counts == want_counts,
              f"{label}: the plan launched {counts}, want {want_counts} "
              f"(route {route})")
        for k, v in counts.items():
            launches[k] += v
    check(routes[cases[0][0]] == "scan" and routes[cases[4][0]] == "checked",
          f"the memory plans take the scan, the time plans the checked fold: {routes}")
    rec = {"card": smi, "cut": DP_CUT, "cases": {}}
    for label, C, model, W, Pi in cases:
        walls, hosts, stages = [], [], None
        for _ in range(2):
            t0 = time.perf_counter()
            got = device_plan(C, model, W, Pi, dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            dp_partition(C, model, W, row_partition=Pi)
            hosts.append((time.perf_counter() - t0) * 1e3)
            staged, stages = dp_stages(C, model, W, Pi, device=dev)
            check(staged == got, f"{label}: dp_stages planned otherwise")
        inputs = dp_inputs(C, model, W, Pi, device=dev)
        passes = dp_passes_ms(inputs, W, dev)
        cut, cut_counts = dp_against_plain(label, C, model, W, Pi, dev)
        for k, v in cut.items():
            errs[k] = max(errs.get(k, 0.0), v)
        fold = {k: stages[k] for k in ("restarts", "rewalked", "folded")}
        rec["cases"][label] = {
            "n": C.n, "nnz": C.nnz, "W": W,
            "R": 1 if inputs[2] is None else int(inputs[2].shape[0]),
            "route": stages["route"], **fold, "stripes": len(got),
            "equal_host": True, "host_dp_ms": min(hosts),
            "device_wall_ms": min(walls),
            "stages_ms": {k: stages[k] for k in STAGES}, "passes_ms": passes,
            "ns_a_step": passes["recurrence"] * 1e6 / C.n, "cut_max_abs": cut,
            "cut_checked": cut_counts}
        print(f"[17 plan] {label}: n {C.n}, W {W}, route {stages['route']} "
              f"(restarts {fold['restarts']}, re-walked rows {fold['rewalked']}, "
              f"folded rows {fold['folded']}), {len(got)} stripes equal to the host "
              f"DP's; device passes (ms) prev {passes['prev_occurrence']:.3f}, table "
              f"{passes['dp_table']:.3f}, recurrence {passes['recurrence']:.3f}; "
              f"device plan wall {min(walls):.2f} ms against the host C++ DP "
              f"{min(hosts):.2f} ms; stages (host ms) "
              + ", ".join(f"{k} {stages[k]:.3f}" for k in STAGES)
              + f"; cut of {DP_CUT} columns bitwise (checked fold, corrupted "
              f"guess: {cut_counts['corrupted']['restarts']} restarts)", flush=True)
    # the kernels line's numbers: the table and the scan on the flagship's
    # min-memory plan, the checked and the serial fold on its time plan
    label, C, model, W, Pi = cases[0]
    pos, grp, wts, alpha, beta, exact = dp_inputs(C, model, W, Pi, device=dev)
    prevcol = dp_ops.prev_occurrence(pos, grp)
    S = dp_ops.dp_table(pos, grp, prevcol, wts, alpha, beta, W)
    same_function("dp_table plain", lambda: dp_ops.dp_table_plain(
        pos, grp, prevcol, wts, alpha, beta, W), lambda: dp_ops.dp_table(
        pos, grp, prevcol, wts, alpha, beta, W), tol=None)
    t_table = paired_ms([lambda: dp_ops.dp_table(pos, grp, prevcol, wts, alpha, beta, W),
                         lambda: dp_ops.dp_table_plain(pos, grp, prevcol, wts,
                                                       alpha, beta, W)], dev, iters=3)
    table_work, rec_work = dp_work(pos, wts, W)
    ms = {"dp_table": {"ms": t_table[0], "plain_ms": t_table[1], "library_ms": None},
          "dp_recurrence_scan": recurrence_record(label, S, dev)}
    t_label, tC, t_model, tW, tPi = cases[4]
    t_in = dp_inputs(tC, t_model, tW, tPi, device=dev)
    S_time = table_of(tC, t_model, tW, tPi, dev)
    ms["dp_recurrence_checked"], ms["dp_recurrence_serial"], t_counts = fold_records(
        t_label, S_time, dev)
    s_floor = torch.tensor([1.0, 3.0, 2.0, 5.0, 4.0, 7.0, 6.0, 8.0, 1e300],
                           dtype=torch.float64, device=dev) * 1e-3
    check(torch.equal(dp_ops.chain_floor(s_floor, 4096),
                      dp_ops.chain_floor_plain(s_floor, 4096)),
          "chain_floor differs from its plain version")
    n8 = tC.n - tC.n % 8
    ms["dp_recurrence_serial"]["dependent_floor_ms"] = paired_ms(
        [lambda: dp_ops.chain_floor(s_floor, n8)], dev, iters=3)[0] * tC.n / n8
    t_rec_work = dp_work(t_in[0], t_in[2], tW)[1]
    for key, work in (("dp_table", table_work), ("dp_recurrence_scan", rec_work),
                      ("dp_recurrence_serial", t_rec_work),
                      ("dp_recurrence_checked", t_rec_work)):
        ms[key]["bound_ms"], ms[key]["bound_by"] = bound64(*work)
    rec["kernels"] = ms
    rec["checked_time_plan"] = t_counts
    mt, ms_scan = ms["dp_table"], ms["dp_recurrence_scan"]
    ms_chk, ms_ser = ms["dp_recurrence_checked"], ms["dp_recurrence_serial"]
    print(f"[17 plan] {label}: dp_table {mt['ms'] * 1e3:.1f} us (plain "
          f"{mt['plain_ms'] * 1e3:.1f} us, bound {mt['bound_ms'] * 1e3:.2f} us, "
          f"{mt['bound_by']}); dp_recurrence_scan {ms_scan['ms'] * 1e3:.1f} us "
          f"(plain {ms_scan['plain_ms']:.1f} ms on the host clock, bound "
          f"{ms_scan['bound_ms'] * 1e3:.2f} us, {ms_scan['bound_by']}); {t_label}: "
          f"dp_recurrence_checked {ms_chk['ms']:.3f} ms alone "
          f"({ms_chk['ms'] * 1e6 / tC.n:.1f} ns a row), {ms_chk['route_ms']:.3f} ms "
          f"with the scan (the scan {ms_chk['scan_ms']:.3f}; restarts "
          f"{t_counts['scan']['restarts']}, re-walked rows "
          f"{t_counts['scan']['rewalked']}); with the corrupted guess "
          f"{ms_chk['corrupted_ms']:.3f} ms ({t_counts['corrupted']['restarts']} "
          f"restarts, {t_counts['corrupted']['folded']} rows folded); plain "
          f"{ms_chk['plain_ms']:.1f} ms on the host clock; bound "
          f"{ms_chk['bound_ms'] * 1e3:.2f} us, {ms_chk['bound_by']}) beside the "
          f"serial fold {ms_ser['ms']:.3f} ms ({ms_ser['ms'] * 1e6 / tC.n:.1f} ns a "
          f"step; plain {ms_ser['plain_ms']:.1f} ms on the host clock; the "
          f"{tC.n}-step dependent floor {ms_ser['dependent_floor_ms']:.3f} ms)",
          flush=True)
    wide = dp_inputs(C, model, DP_WIDE, Pi, device=dev)
    S_wide = dp_ops.dp_table(*wide[:2], dp_ops.prev_occurrence(*wide[:2]),
                             *wide[2:5], DP_WIDE)
    wide_scan = recurrence_record(f"{label} at W = {DP_WIDE}", S_wide, dev)
    # the route forced to the checked fold on the memory plan's S, and a
    # fractional table at the same width; the serial fold's plain loop
    # (W > 8) is timed, its Python plain version is not (seconds)
    w_chk, w_ser, w_counts = fold_records(f"{label} at W = {DP_WIDE}", S_wide, dev,
                                          serial_plain=False)
    frac_label = f"flagship 1-D fitted_1d({DP_WIDE}, 11)"
    S_frac = table_of(C, fitted_1d(DP_WIDE, 11), DP_WIDE, None, dev)
    f_chk, f_ser, f_counts = fold_records(frac_label, S_frac, dev, serial_plain=False)
    rec["wide"] = {"W": DP_WIDE, "dp_recurrence_scan_ms": wide_scan["ms"],
                   "dp_recurrence_scan_plain_ms": wide_scan["plain_ms"],
                   "dp_recurrence_ms": w_ser["ms"], "ns_a_step": w_ser["ms"] * 1e6 / C.n,
                   "dp_recurrence_checked": w_chk, "checked": w_counts,
                   "fractional": {"dp_recurrence_checked": f_chk,
                                  "dp_recurrence_ms": f_ser["ms"], "checked": f_counts}}
    print(f"[17 plan] {label} at W = {DP_WIDE}: dp_recurrence_scan "
          f"{wide_scan['ms'] * 1e3:.1f} us, bitwise its plain version and the "
          f"serial fold; the checked fold {w_chk['ms']:.3f} ms alone "
          f"({w_chk['route_ms']:.3f} with the scan; restarts "
          f"{w_counts['scan']['restarts']}; corrupted guess {w_chk['corrupted_ms']:.3f} "
          f"ms, {w_counts['corrupted']['restarts']} restarts) "
          f"beside the serial fold's plain loop {w_ser['ms']:.3f} ms "
          f"({w_ser['ms'] * 1e6 / C.n:.1f} ns a step); {frac_label}: the checked "
          f"fold {f_chk['ms']:.3f} ms alone ({f_chk['route_ms']:.3f} with the scan; "
          f"restarts {f_counts['scan']['restarts']}; corrupted guess "
          f"{f_chk['corrupted_ms']:.3f} ms, {f_counts['corrupted']['restarts']} "
          f"restarts) beside the serial fold "
          f"{f_ser['ms']:.3f} ms, all bitwise", flush=True)
    rec["seconds_dp"] = time.perf_counter() - t_phase
    print("PLAN " + json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    pack = probe_pack.run("all", dev)
    print("PACK " + json.dumps({"card": smi, "stages_s": pack,
                                "seconds": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    rows = weak_scaling.measure(WEAK_L0, WEAK_WORLD, dev, reps=WEAK_REPS)
    model = weak_scaling.analytic(rows)
    print(f"[17 weak] l0 {WEAK_L0}: "
          + "; ".join(f"N={r['ndev']} {r['path']} ({r['backend']}) "
                      f"{r['t_us']:.1f} us wall, {r['gnnz_s']:.3f} Gnnz/s; kernels "
                      f"{'-' if r['kernel_us'] is None else format(r['kernel_us'], '.2f')}"
                      f" us; halo {r['halo_kib']:.0f} KiB, eff "
                      f"{'-' if r['efficiency'] is None else format(r['efficiency'], '.3f')}"
                      for r in rows)
          + f"; the model's card rate {model['single_card_gnnz_s']:.3f} Gnnz/s "
          f"({model['rate_from']}) beside the wall's {model['wall_gnnz_s']:.3f}"
          f"; NOTE: {weak_scaling.SHARED_CARD}", flush=True)
    print("WEAK " + json.dumps({"card": smi, "l0": WEAK_L0, "rows": rows,
                                "analytic_model": model,
                                "seconds": time.perf_counter() - t0}), flush=True)
    return launches, ms


# trace.launches_by_map() at the last reset_launches()
_MAPS_AT_RESET: dict = {}


def reset_launches():
    for kern in KERNELS:
        kern.launches = 0
    _MAPS_AT_RESET.update(trace.launches_by_map())


def maps_since_reset() -> dict:
    """The stripe TrSpMV's launches by thread map since the last
    :func:`reset_launches`."""
    return {k: n - _MAPS_AT_RESET.get(k, 0) for k, n in trace.launches_by_map().items()}


@contextlib.contextmanager
def counting_index_select():
    """Counts the calls of ``index_select`` inside the block (the row
    gathers that an auto-RCM operator no longer runs): yields a one-item
    list."""
    calls = [0]

    def counting(fn):
        def wrapped(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(torch.Tensor, "index_select",
                           counting(torch.Tensor.index_select)), \
            mock.patch.object(torch, "index_select", counting(torch.index_select)):
        yield calls


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    errs = {k.__name__: 0.0 for k in KERNELS}
    phase_kernels(dev, errs)
    phase_kernels_slice4(dev, errs)
    phase_chain_repair(dev)

    # the f32 calls of phases 4-10 never enter ops/semiring.py
    f32_path = contextlib.ExitStack()
    semi = f32_path.enter_context(counting_semiring())

    # four calls: flagship tr_mul and mul, FEM tr_mul and mul (natural
    # views), each one launch of its route's kernel (a vector by the
    # ordered scatter: its products and rows launches, by block), no gather
    reset_launches()
    with counting_index_select() as sel:
        flag = phase_flagship(dev)
        fem = phase_fem(dev)
    launches = {"tr_spmv": vt.tr_spmv.launches,
                "tr_spmv_scatter": vt.tr_spmv_scatter.launches,
                "mul_ordered": vt.mul_ordered.launches}
    names = [o.route_tr[0] for o in (flag[1], fem[1])] + [
        o.route_fw[0] for o in (flag[1], fem[1])]
    want = {"tr_spmv": names.count("stripe"),
            "tr_spmv_scatter": names.count("scatter"),
            "mul_ordered": 2 * names.count("ordered")}
    maps = maps_since_reset()
    ordered = {k: maps[k] for k in ("ordered_products", "ordered_rows")}
    check(launches == want and vt.gather.launches == 0 and sel[0] == 0
          and ordered == dict.fromkeys(ordered, names.count("ordered")),
          f"tr_mul/mul path: {launches}, {ordered}, gather {vt.gather.launches}, "
          f"index_select {sel[0]} (want {want} by the routes {names}, one "
          f"products and one rows launch an ordered call, gather 0, "
          f"index_select 0)")
    print(f"[4-5 launches] tr_mul/mul path, 4 calls ({', '.join(names)}): stripe "
          f"TrSpMV {launches['tr_spmv']}, scatter TrSpMV "
          f"{launches['tr_spmv_scatter']}, ordered scatter {launches['mul_ordered']}, "
          f"gather {vt.gather.launches}, index_select {sel[0]}", flush=True)

    reset_launches()
    with counting_index_select() as sel:
        spmm = phase_spmm(dev, flag, fem)
    launches["tr_spmm"] = vt.tr_spmm.launches
    # a mul_mat whose operator holds its forward products on A's pack
    # (operator.forward_pack) runs the ordered scatter instead: its
    # products launch and, with rows of no block or several, its rows one
    on_a = sum(o.fw_on_a for o in (flag[1], fem[1]))
    launches["mul_ordered"] = vt.mul_ordered.launches
    scatter_calls = maps_since_reset()["ordered_products"]
    check(launches["tr_spmm"] == 5 - on_a and scatter_calls == on_a
          and vt.gather.launches == 0 and sel[0] == 0,
          f"tr_mul_mat/mul_mat path: SpMM {launches['tr_spmm']} (want "
          f"{5 - on_a}, one a call), ordered scatter {scatter_calls} calls (want "
          f"{on_a}), gather {vt.gather.launches}, index_select {sel[0]} (want 0)")
    print(f"[4-6 launches] tr_mul_mat/mul_mat path, 5 calls: SpMM "
          f"{launches['tr_spmm']}, ordered scatter {launches['mul_ordered']} "
          f"launches, gather {vt.gather.launches}, index_select {sel[0]}",
          flush=True)

    reset_launches()
    parts = phase_2d(dev)
    launches["tr_spmv_2d"] = vt.tr_spmv_2d.launches
    spmm_2d = vt.tr_spmm.launches
    check(launches["tr_spmv_2d"] > 0 and spmm_2d == 4,
          f"2-D path: tile TrSpMV {launches['tr_spmv_2d']}, SpMM {spmm_2d} "
          f"(want 4), stripe TrSpMV {vt.tr_spmv.launches} launches")
    launches["tr_spmv"] += vt.tr_spmv.launches  # the view route's
    launches["tr_spmm"] += spmm_2d
    print(f"[7 launches] 2-D path: tile TrSpMV {launches['tr_spmv_2d']}, stripe "
          f"TrSpMV on the view route {vt.tr_spmv.launches}, SpMM on the 1-D "
          f"views {spmm_2d}", flush=True)

    reset_launches()
    chains = phase_chain(flag, fem)
    launches["tr_spmv_chain"] = vt.tr_spmv_chain.launches
    # the auto-RCM chain's perm is in the chain kernel: no path gathers now
    launches["gather"] = vt.gather.launches
    launches["gather_tiles"] = 0  # the halo paths' (phase 16)
    others = {k.__name__: k.launches for k in KERNELS if k is not vt.tr_spmv_chain}
    check(launches["tr_spmv_chain"] == 4 and not any(others.values()),
          f"chain path: chain {launches['tr_spmv_chain']} launches (want 4, "
          f"one per call), others {others} (want none: no gather)")
    print(f"[9 launches] tr_mul_chain path, 4 calls: chain kernel "
          f"{launches['tr_spmv_chain']}, gather {vt.gather.launches}", flush=True)

    reset_launches()
    with counting_index_select() as sel:
        scat = phase_scatter(dev, flag, fem, spmm)
    n_scat = vt.tr_spmv_scatter.launches
    check(n_scat == 2 and vt.tr_spmv.launches == 0 and vt.gather.launches == 0
          and sel[0] == 0,
          f"scatter path: scatter TrSpMV {n_scat} (want 2, one a call), stripe "
          f"TrSpMV {vt.tr_spmv.launches}, gather {vt.gather.launches}, "
          f"index_select {sel[0]}")
    launches["tr_spmv_scatter"] += n_scat  # beside the flagship's mul
    f32_path.close()
    check(semi[0] == 0, f"an f32 call entered ops/semiring.py {semi[0]} times")
    print(f"[10 launches] scattered tr_mul/mul path, 2 calls: scatter TrSpMV "
          f"{n_scat}, gather {vt.gather.launches}, index_select {sel[0]}",
          flush=True)

    reset_launches()
    rel = phase_relayout(dev)
    launches["tile_relayout"] = vt.tile_relayout.launches
    check(launches["tile_relayout"] == 1, "relayout op did not launch its kernel")

    phase_path_shapes(flag, fem, spmm, errs)
    phase_path_shapes_2d(parts, errs)
    scat_routes = {f"{label} {d}": route[1]
                   for label, o in (("flagship", flag[1]), ("FEM", fem[1]),
                                    ("scattered", scat[1]))
                   for d, route in (("A", o.route_tr), ("A.T", o.route_fw))
                   if route[0] == "scatter"}
    phase_path_shapes_slice4(chains, scat_routes, rel, errs)
    ms = phase_timing(dev, flag, fem, spmm)
    ms["tr_spmm"] = phase_timing_spmm(dev, flag, fem, spmm, parts)
    ms["mul_ordered"] = phase_timing_ordered(dev, flag, spmm, errs)
    ms["tr_spmv"].update(phase_timing_above_l2(dev, errs))
    ms["tr_spmv_staged"], launches["tr_spmv_staged"] = phase_timing_cells(dev, errs)
    ms["tr_spmv"]["cells"] = phase_timing_unpermuted(dev, errs)
    ms["tr_spmv_staged_f64"], launches["tr_spmv_staged_f64"] = phase_timing_cells_f64(
        dev, errs)
    ms_2d, pairs_2d = phase_timing_2d(dev, parts)
    ms.update(ms_2d)
    ms.update(phase_timing_slice4(dev, chains, scat, rel, pairs_2d))
    phase_timing_relabeled(dev, fem, scat, spmm)
    phase_chain_fold(dev, chains)
    ms["gather_tiles"] = phase_timing_tiles(dev, flag, parts, errs)
    p_launches, p_errs, p_ms = phase_probes(
        dev, ms["tr_spmv_chain"]["barrier_floor_ms"])
    launches.update(p_launches)
    errs.update(p_errs)
    ms.update(p_ms)
    print(f"[8, 12 relayout] tile_relayout at R={rel[1]} "
          f"{ms['tile_relayout']['ms'] * 1e3:.2f} us warm (bound "
          f"{ms['tile_relayout']['bound_ms'] * 1e3:.2f} us) beside the launch "
          f"probe's floor, one add_one launch, {ms['add_one']['ms'] * 1e3:.2f} us",
          flush=True)

    phase_semiring(dev, flag)
    reset_launches()
    mdl, mdl2, _ = phase_autotune(dev, flag)
    tuned = {k.__name__: k.launches for k in KERNELS if k.launches}
    check(tuned.get("tr_spmv", 0) + tuned.get("tr_spmv_scatter", 0) > 0
          and tuned.get("tr_spmv_2d", 0) + tuned.get("tr_spmv", 0) > 0,
          f"the autotuner did not time the routed kernels: {tuned}")
    reset_launches()
    phase_table(dev, flag, mdl, mdl2)
    tabled = {k.__name__: k.launches for k in KERNELS if k.launches}
    check(tabled.get("tr_spmv", 0) + tabled.get("tr_spmv_scatter", 0)
          + tabled.get("tr_spmv_2d", 0) > 0,
          f"the method table did not run the routed kernels: {tabled}")
    print(f"[14-15 launches] autotune {tuned}; method table {tabled}", flush=True)
    reset_launches()
    d_launches = phase_dist(dev, flag, parts, smi, errs)
    for k, v in d_launches.items():
        launches[k] += v
    print(f"[16 launches] the distributed paths, summed over ranks and worlds: "
          f"{d_launches}", flush=True)
    p_launches, p_ms = phase_plan(dev, flag, fem, mdl, mdl2, smi, errs)
    launches.update(p_launches)
    ms.update(p_ms)
    print(f"[17 launches] the plans: {p_launches}", flush=True)
    check("jax" not in sys.modules, "the port loaded JAX")
    meta = [
        ("tr_spmv_stripe", "tr_spmv", "trspmv.cu",
         "vbcs_tpu/ops/pallas_trspmv3.py:1145"),
        ("tr_spmv_staged", "tr_spmv_staged", "trspmv.cu",
         "vbcs_tpu/ops/pallas_trspmv3.py:1145 (the staged map, on the benchmark "
         "cells' natural views)"),
        ("tr_spmv_staged_f64", "tr_spmv_staged_f64", "trspmv.cu",
         "vbcs_tpu/ops/pallas_trspmv3.py:1145 (the staged map in f64, on the float64 "
         "cell's natural view; the JAX operators run f64 on XLA)"),
        ("gather", "gather", "gather.cu", "vbcs_tpu/ops/windowed_gather.py:184"),
        ("gather_tiles", "gather_tiles", "gather.cu",
         "vbcs_tpu/ops/windowed_gather.py:184 (the halo paths' tile maps)"),
        ("tr_spmm", "tr_spmm", "spmm.cu",
         "vbcs_tpu/ops/pallas_spmm4.py:209, vbcs_tpu/ops/pallas_spmm3.py:42, "
         "vbcs_tpu/ops/pallas_spmm.py:33, vbcs_tpu/ops/pallas_trspmv.py:215"),
        ("mul_ordered", "mul_ordered", "ordered.cu",
         "none: A @ X on A's own pack, where the JAX package runs (A.T).T @ X "
         "on A.T's (vbcs_tpu/operator.py mul_mat)"),
        ("tr_spmv_2d", "tr_spmv_2d", "trspmv2d.cu",
         "vbcs_tpu/ops/pallas_trspmv2d.py:336, vbcs_tpu/ops/pallas_trspmv2.py:435"),
        ("tr_spmv_chain", "tr_spmv_chain", "chain.cu",
         "vbcs_tpu/ops/pallas_trspmv3.py:954"),
        ("tr_spmv_scatter", "tr_spmv_scatter", "scatter.cu",
         "vbcs_tpu/ops/pallas_scatter.py:185"),
        ("tile_relayout", "tile_relayout", "relayout.cu",
         "vbcs_tpu/ops/pallas_trspmv3.py:1117"),
        ("probe_add_one", "add_one", "probe_launch.cu", "bench_tools/probe_launch.py:22"),
        ("probe_chunk", "chunk", "probe_chunk.cu",
         "bench_tools/probe_kernel.py:78, bench_tools/probe_kernel2.py:71"),
        ("probe_chain", "chain", "probe_chain.cu", "bench_tools/probe_chain.py:66"),
        ("probe_spmm4_fma", "fma", "probe_spmm4.cu", "bench_tools/probe_spmm4.py:45"),
        ("dp_table", "dp_table", "dp.cu",
         "vbcs_tpu/plan/jax_dp.py:54, vbcs_tpu/plan/jax_dp.py:155 (lax.scan)"),
        ("dp_recurrence", "dp_recurrence_serial", "dp.cu",
         "vbcs_tpu/plan/jax_dp.py:54, vbcs_tpu/plan/jax_dp.py:155 (lax.scan)"),
        ("dp_recurrence_scan", "dp_recurrence_scan", "dp_scan.cu",
         "vbcs_tpu/plan/jax_dp.py:54, vbcs_tpu/plan/jax_dp.py:155 (lax.scan)"),
        ("dp_recurrence_checked", "dp_recurrence_checked", "dp_checked.cu",
         "vbcs_tpu/plan/jax_dp.py:54, vbcs_tpu/plan/jax_dp.py:155 (lax.scan)"),
    ]
    rec = [{"name": name, "route": "cuda",
            "source": f"vbcs_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key], **ms[key]}
           for name, key, src, replaces in meta]
    idle = sorted(r["name"] for r in rec if r["launches"] == 0)
    check(idle == ["dp_recurrence", "gather"],
          f"kernels launched no time on their paths: {idle} (only the serial "
          f"fold and the element gather, each timed as a yardstick, run on no "
          f"path)")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all, the build "
          f"included", flush=True)
    print(smi)
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
