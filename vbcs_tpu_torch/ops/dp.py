"""The split-point DP's kernels: the stripe-cost table and the recurrence.

Counterpart of ``vbcs_tpu/plan/jax_dp.py``'s cores (``dp_partition_jax``,
``dp_partition_jax_2d``: one ``lax.scan`` over the columns).  The port
splits what the scan computes into its parallel part and its chain:

* :func:`prev_occurrence` (torch ops, any device): for each nonzero, the
  column of the previous nonzero of its group in column-major order, or
  -1 (a stable sort by group);
* :func:`dp_table` (``csrc/dp.cu`` on a CUDA tensor): ``S[jp - 1, w - 1]``,
  the cost of the stripe of columns ``[jp - w, jp)``, from the host DP's
  counters replayed over the W columns before ``jp`` (inf where ``w > jp``);
* :func:`dp_recurrence`: ``opt[jp] = min_w opt[jp - w] + S[jp - 1, w - 1]``
  and the back pointers ``prev``, the narrowest stripe winning ties, by one
  of two kernels: on exact cost tables (:func:`exact_tables`, decided on the
  host from the model's tables) the parallel (min,+) scan
  :func:`dp_recurrence_scan` (``csrc/dp_scan.cu``), else the checked
  speculative fold :func:`dp_recurrence_checked` (``csrc/dp_checked.cu``):
  the scan's back pointers walked one add a row and checked, a chunk
  behind, against the host's order of sums, which alone reproduces the
  host's sums on fractional tables;
* :func:`dp_recurrence_serial` (``csrc/dp.cu``): the serial fold, the
  yardstick the checked fold is timed against (on no plan's path);
* :func:`chain_floor` (``csrc/dp.cu``): the serial fold's dependent path
  alone, a measurement of the floor of its n steps (not on the DP's path).

The table, the serial fold and the checked fold compute in f64 in the
order of the C++ DP (``native/vbc_native.cpp`` ``dp_partition``); the scan
regroups the sums, which changes no bit where every sum is exact.  So the
split points are that DP's bit for bit.  On a CPU tensor each wrapper runs
its plain version (:func:`dp_table_plain`, :func:`dp_recurrence_plain`,
:func:`dp_recurrence_scan_plain`, :func:`dp_recurrence_checked_plain`); on
a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from . import _lib

__all__ = ["prev_occurrence", "dp_table", "dp_table_plain", "exact_tables",
           "dp_recurrence", "dp_recurrence_plain", "dp_recurrence_serial",
           "dp_recurrence_scan", "dp_recurrence_scan_plain", "scan_layout",
           "dp_recurrence_checked", "dp_recurrence_checked_plain", "check_budget",
           "chain_floor", "chain_floor_plain"]

INF = float("inf")
# csrc/dp_scan.cu's kRows, kThreads, kMaxChunks and kSmallW
SCAN_ROWS, SCAN_THREADS, SCAN_MAX_CHUNKS, SCAN_SMALL_W = 64, 512, 128, 16
# the checked fold: rows a chunk, and the restarts it allows before the
# host-order fold, CHECK_SPARE_RESTARTS plus one a CHECK_RESTART_ROWS rows
CHECK_ROWS, CHECK_SPARE_RESTARTS, CHECK_RESTART_ROWS = 256, 16, 4096


def _binary_exponent(a) -> int:
    """The least ``e >= 0`` with every finite entry of ``a`` a multiple of
    ``2**-e`` (every finite double is such a multiple for some ``e``)."""
    vals = np.unique(np.asarray(a, dtype=np.float64))
    return max([Fraction(float(x)).denominator.bit_length() - 1
                for x in vals[np.isfinite(vals)]], default=0)


def exact_tables(alpha, beta, wts, groups: int, n: int) -> bool:
    """Whether every sum the DP forms is exact in f64, so that any grouping
    of the recurrence's sums gives the serial fold's bits: the scan's
    route.  Host arrays: ``alpha`` ``[W]``, ``beta`` ``[R, W]``, ``wts``
    ``[R, groups]`` or None (unit weights over ``groups`` groups); ``n``
    columns.

    A counter is a sum of +-weights, at most ``c_r = sum_g |wts[r, g]|`` in
    size and a multiple of ``2**-e_w``; a stripe cost ``alpha + sum_r a_r *
    beta_r`` is at most ``s = max|alpha| + sum_r c_r max|beta_r|`` and a
    multiple of ``2**-e``, ``e = max(e_alpha, e_w + e_beta)``; a plan's cost
    is at most ``n s``.  All are exact when ``c_r < 2**(53 - e_w)`` and
    ``n s < 2**(52 - e)`` (one bit spare for the float sum of the bound).
    Integer tables (the memory models) and binary fractions pass; fitted
    time models do not."""
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    e_w = 0 if wts is None else _binary_exponent(wts)
    e = max(_binary_exponent(alpha), e_w + _binary_exponent(beta))
    counts = (np.full(beta.shape[0], float(groups)) if wts is None
              else np.abs(np.asarray(wts, dtype=np.float64)).sum(axis=1))
    smax = (np.abs(alpha).max(initial=0.0)
            + float((counts * np.abs(beta).max(axis=1, initial=0.0)).sum()))
    return bool((counts < math.ldexp(1.0, 53 - e_w)).all()
                and n * smax < math.ldexp(1.0, 52 - e))


def prev_occurrence(pos: torch.Tensor, grp: torch.Tensor) -> torch.Tensor:
    """``prevcol[q]``: the column of the last nonzero before ``q`` (in
    column-major order) with group ``grp[q]``, or -1; what the host DP's
    last-occurrence table ``lst[g]`` holds when it reaches ``q``.  int64
    ``pos`` ``[n + 1]`` and ``grp`` ``[nnz]`` on one device."""
    n, nnz = pos.numel() - 1, grp.numel()
    col = torch.repeat_interleave(torch.arange(n, device=pos.device),
                                  pos.diff(), output_size=nnz)
    order = torch.sort(grp, stable=True).indices  # q ascending within a group
    same = grp[order[1:]] == grp[order[:-1]]
    prev_q = torch.full((nnz,), -1, dtype=torch.int64, device=grp.device)
    prev_q[order[1:]] = torch.where(same, order[:-1], -1)
    return torch.where(prev_q >= 0, col[prev_q.clamp(min=0)], -1)


def _check(pos, grp, prevcol, wts, alpha, beta, W):
    dev = pos.device
    if W < 1:
        raise ValueError(f"width cap W must be >= 1, got {W}")
    for name, t, dtype in (("pos", pos, torch.int64), ("grp", grp, torch.int64),
                           ("prevcol", prevcol, torch.int64),
                           ("alpha", alpha, torch.float64),
                           ("beta", beta, torch.float64)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if wts is not None and (wts.dtype != torch.float64 or wts.device != dev
                            or not wts.is_contiguous() or wts.dim() != 2):
        raise ValueError(f"wts must be a contiguous 2-D float64 tensor on {dev}")
    R = beta.shape[0]
    if alpha.shape != (W,) or beta.shape != (R, W) or R < 1:
        raise ValueError(f"alpha must be [W], beta [R, W] with W = {W}, got "
                         f"{tuple(alpha.shape)} and {tuple(beta.shape)}")
    if wts is None and R != 1:
        raise ValueError("unit weights (wts None) take one counter (R = 1)")
    if wts is not None and wts.shape[0] != R:
        raise ValueError(f"wts has {wts.shape[0]} rows, beta {R}")
    if grp.shape != prevcol.shape or grp.dim() != 1 or pos.dim() != 1:
        raise ValueError("pos, grp and prevcol must be 1-D, grp and prevcol alike")


def dp_table_plain(pos, grp, prevcol, wts, alpha, beta, W: int) -> torch.Tensor:
    """Plain PyTorch stripe-cost table, the kernel's arithmetic in its
    order.  The host DP's counter updates are events (per nonzero ``q``:
    ``-w`` at ``prevcol[q]``, then ``+w`` at its own column); grouped by
    the counter they hit, in the host's order, they are applied rank by
    rank (a rank touches each counter once), and ``cnt[t]`` as the sweep
    reaches column ``t + a`` is the running value after the last event of
    age ``<= a``."""
    n, nnz, R = pos.numel() - 1, grp.numel(), beta.shape[0]
    dev = pos.device
    S = torch.full((n, W), INF, dtype=torch.float64, device=dev)
    if n == 0:
        return S
    col = torch.repeat_interleave(torch.arange(n, device=dev), pos.diff(),
                                  output_size=nnz)
    q = torch.arange(nnz, device=dev)
    w_q = (torch.ones((1, nnz), dtype=torch.float64, device=dev) if wts is None
           else wts[:, grp])
    seen = (prevcol >= 0).nonzero().squeeze(1)
    key = torch.cat([2 * seen, 2 * q + 1])  # the host's order of the updates
    tgt = torch.cat([prevcol[seen], col])
    age = torch.cat([col[seen] - prevcol[seen], torch.zeros_like(col)])
    delta = torch.cat([-w_q[:, seen], w_q], dim=1)
    order = torch.argsort(key)
    order = order[torch.sort(tgt[order], stable=True).indices]
    tgt, age, delta = tgt[order], age[order], delta[:, order]
    E = tgt.numel()
    counts = torch.bincount(tgt, minlength=n)
    rank = torch.arange(E, device=dev) - (torch.cumsum(counts, 0) - counts)[tgt]
    by_rank = torch.sort(rank, stable=True).indices
    val = torch.zeros((R, n), dtype=torch.float64, device=dev)
    run = torch.empty((R, E), dtype=torch.float64, device=dev)
    start = 0
    for size in torch.bincount(rank).tolist():
        sel = by_rank[start:start + size]
        t = tgt[sel]
        val[:, t] = val[:, t] + delta[:, sel]
        run[:, sel] = val[:, t]
        start += size
    keep = age < W
    last = torch.full((n * W,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, (tgt * W + age)[keep],
                         torch.arange(E, device=dev)[keep], "amax")
    last = torch.cummax(last.view(n, W), dim=1).values
    cnt = (torch.where(last >= 0, run[:, last.clamp(min=0)], 0.0) if E  # [R, n, W]
           else torch.zeros((R, n, W), dtype=torch.float64, device=dev))
    a = torch.zeros((R, n), dtype=torch.float64, device=dev)
    for w in range(1, min(W, n) + 1):
        a[:, w - 1:] = a[:, w - 1:] + cnt[:, :n - w + 1, w - 1]
        stripe = alpha[w - 1].expand(n - w + 1)
        for r in range(R):
            stripe = stripe + a[r, w - 1:] * beta[r, w - 1]
        S[w - 1:, w - 1] = stripe
    return S


def dp_table(pos: torch.Tensor, grp: torch.Tensor, prevcol: torch.Tensor,
             wts, alpha: torch.Tensor, beta: torch.Tensor, W: int) -> torch.Tensor:
    """``S`` ``[n, W]`` f64: ``S[jp - 1, w - 1] = alpha[w - 1] + sum_r
    a_r * beta[r, w - 1]``, ``a_r`` the weight (``wts[r, g]``, or 1 when
    ``wts`` is None) of the distinct groups in columns ``[jp - w, jp)``;
    inf where ``w > jp``.  ``prevcol`` is :func:`prev_occurrence`'s."""
    _check(pos, grp, prevcol, wts, alpha, beta, W)
    dev = pos.device
    if dev.type == "cpu":
        return dp_table_plain(pos, grp, prevcol, wts, alpha, beta, W)
    if dev.type != "cuda":
        raise NotImplementedError(f"no DP kernel for device {dev}")
    n, R = pos.numel() - 1, beta.shape[0]
    S = torch.empty((n, W), dtype=torch.float64, device=dev)
    if n == 0:
        return S
    # the counter windows go to device memory when shared memory cannot
    # hold them; the kernel's source decides
    k = _lib.load().vbcs_dp_table_scratch_doubles(n, W, R)
    scratch = torch.empty(k, dtype=torch.float64, device=dev) if k else None
    _lib.launch(dp_table, "vbcs_dp_table", dev, n, W, R,
                0 if wts is None else wts.shape[1], pos.data_ptr(), grp.data_ptr(),
                prevcol.data_ptr(), _lib.ptr(wts), alpha.data_ptr(), beta.data_ptr(),
                S.data_ptr(), _lib.ptr(scratch))
    return S


def dp_recurrence_plain(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain recurrence: the host DP's loop on Python floats (IEEE f64)."""
    n, W = S.shape
    rows = S.tolist()
    opt = [0.0] + [INF] * n
    prev = [0] * (n + 1)
    for jp in range(1, n + 1):
        best, bj, row = INF, jp - 1, rows[jp - 1]
        for w in range(1, min(W, jp) + 1):
            cost = opt[jp - w] + row[w - 1]
            if cost < best:
                best, bj = cost, jp - w
        opt[jp], prev[jp] = best, bj
    return (torch.tensor(prev, dtype=torch.int64, device=S.device),
            torch.tensor(opt, dtype=torch.float64, device=S.device))


def _check_S(S: torch.Tensor) -> None:
    if S.dtype != torch.float64 or S.dim() != 2 or not S.is_contiguous():
        raise ValueError("S must be a contiguous 2-D float64 tensor")
    if S.shape[1] < 1:
        raise ValueError(f"width cap W must be >= 1, got {S.shape[1]}")
    if S.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no DP kernel for device {S.device}")


def dp_recurrence(S: torch.Tensor, exact: bool = False, stats: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(prev, opt)``, each ``[n + 1]`` (int64, f64), from ``S`` ``[n, W]``
    f64: ``opt[0] = 0``, ``opt[jp] = min_{w <= min(W, jp)} opt[jp - w] +
    S[jp - 1, w - 1]`` and ``prev[jp]`` the ``jp - w`` of the first
    minimum over ascending ``w`` (``jp - 1`` when ``opt[jp]`` is inf).
    ``exact`` (:func:`exact_tables` of the tables that made S) routes to
    the scan, :func:`dp_recurrence_scan`; else, on a CUDA tensor, the
    checked fold :func:`dp_recurrence_checked` on the scan's back pointers,
    and on a CPU tensor the host loop :func:`dp_recurrence_plain`.  With
    ``stats`` a dict, the checked fold's counters go there as ints
    (``restarts``, ``rewalked``, ``folded``; 0 on the other routes), which
    waits for the card."""
    _check_S(S)
    counts = torch.zeros(3, dtype=torch.int64)
    if exact:
        prev, opt = dp_recurrence_scan(S)
    elif S.device.type == "cpu":
        prev, opt = dp_recurrence_plain(S)
    else:
        prev, opt, counts = dp_recurrence_checked(S)
    if stats is not None:
        stats.update(zip(("restarts", "rewalked", "folded"), counts.tolist()))
    return prev, opt


def dp_recurrence_serial(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dp_recurrence` by the serial fold (``csrc/dp.cu``), the host's
    loop on one thread, whose launches ``dp_recurrence_serial.launches``
    counts: the yardstick of :func:`dp_recurrence_checked`, on no plan's
    path."""
    _check_S(S)
    n, W = S.shape
    dev = S.device
    if dev.type == "cpu":
        return dp_recurrence_plain(S)
    opt = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    prev = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        return prev, opt
    _lib.launch(dp_recurrence_serial, "vbcs_dp_recurrence", dev, n, W, S.data_ptr(),
                opt.data_ptr(), prev.data_ptr())
    return prev, opt


def scan_layout(n: int, W: int) -> tuple[int, int, int, int, int]:
    """``(We, L, K, B, nb)`` of the scan on ``S`` ``[n, W]``, n > 0: the
    state's width ``min(W, n)``, rows a chunk, chunks, chunks a block and
    blocks (``csrc/dp_scan.cu`` ``layout``: a lane a chunk's padded state
    slot, the power of two at or above We up to ``SCAN_SMALL_W``, We
    above; ``SCAN_THREADS`` lanes a block)."""
    We = min(W, n)
    Wp = 1 << (We - 1).bit_length() if We <= SCAN_SMALL_W else We
    L = max(SCAN_ROWS, We)
    K = -(-n // L)
    B = max(1, min(SCAN_MAX_CHUNKS, SCAN_THREADS // Wp))
    return We, L, K, B, -(-K // B)


def _matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = min_k A[..., i, k] + v[..., k]``."""
    return (A + v[..., None, :]).amin(-1)


def dp_recurrence_scan_plain(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain scan in torch ops: the kernel's chunks, blocks and order of
    (min,+) products, each add of the same two operands, so that kernel
    and plain version are bitwise equal on any finite S.  Matrices here
    are ``[..., i, k]``: ``out[i] = min_k M[i, k] + in[k]``."""
    n, W = S.shape
    dev, f64 = S.device, torch.float64
    opt = torch.zeros(n + 1, dtype=f64, device=dev)
    prev = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        return prev, opt
    We, L, K, B, nb = scan_layout(n, W)
    rows = torch.full((K * L, We), INF, dtype=f64, device=dev)
    rows[:n] = S[:, :We]
    rows = rows.view(K, L, We).flip(-1)  # column j: w = We - j
    lane = torch.arange(We, device=dev)
    # pass 1: lane k of each chunk from the unit start e_k; hist[c, k, We - 1 + p]
    # holds position p (p <= 0: the start's slot -p)
    hist = torch.full((K, We, L + We), INF, dtype=f64, device=dev)
    hist[:, lane, We - 1 - lane] = 0.0
    for t in range(L):  # position t + 1 from positions t + 1 - We .. t
        hist[:, :, We + t] = (hist[:, :, t:t + We] + rows[:, t, None, :]).amin(-1)
    # M[c, i, k]: position L - i; each block's prefix products (Hillis-Steele,
    # Q_c <- Q_c (x) Q_{c-d}), the blocks padded to B chunks
    Q = torch.full((nb * B, We, We), INF, dtype=f64, device=dev)
    Q[:K] = hist[:, :, We - 1 + L - lane].transpose(1, 2)
    Q = Q.view(nb, B, We, We)
    d = 1
    while d < B:
        Q = torch.cat([Q[:, :d], (Q[:, d:, :, :, None] + Q[:, :-d, None, :, :]).amin(3)], 1)
        d *= 2
    # pass 2: each block's start by the chain over the aggregates before it,
    # then each chunk's from the prefix before it
    v = torch.full((We,), INF, dtype=f64, device=dev)
    v[0] = 0.0
    vb = [v]
    for b in range(nb - 1):
        vb.append(_matvec(Q[b, B - 1], vb[-1]))
    vb = torch.stack(vb)
    st = torch.cat([vb[:, None], _matvec(Q[:, :B - 1], vb[:, None])], 1)
    st = st.reshape(nb * B, We)[:K]  # st[c, j] = opt[cL - j]
    # the replay from each chunk's start: the first minimum over ascending w
    h = torch.full((K, L + We), INF, dtype=f64, device=dev)
    h[:, :We] = st.flip(-1)
    bw = torch.empty((K, L), dtype=torch.int64, device=dev)
    for t in range(L):
        cand = h[:, t:t + We] + rows[:, t]
        best = cand.amin(-1)
        j = torch.where(cand == best[:, None], lane, -1).amax(-1)
        h[:, We + t] = best
        bw[:, t] = We - j
    opt[1:] = h[:, We:].reshape(-1)[:n]
    prev[1:] = torch.arange(1, n + 1, device=dev) - bw.reshape(-1)[:n]
    return prev, opt


def dp_recurrence_scan(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dp_recurrence` by the parallel (min,+) scan
    (``csrc/dp_scan.cu``): the serial fold's bits wherever every sum is
    exact (:func:`exact_tables`), any ``W``."""
    _check_S(S)
    n, W = S.shape
    dev = S.device
    if dev.type == "cpu":
        return dp_recurrence_scan_plain(S)
    opt = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    prev = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        return prev, opt
    scratch = torch.empty(_lib.load().vbcs_dp_scan_scratch_doubles(n, W),
                          dtype=torch.float64, device=dev)
    _lib.launch(dp_recurrence_scan, "vbcs_dp_scan", dev, n, W, S.data_ptr(),
                opt.data_ptr(), prev.data_ptr(), scratch.data_ptr())
    return prev, opt


def check_budget(n: int) -> int:
    """The checked fold's restart budget on ``n`` rows:
    ``CHECK_SPARE_RESTARTS`` and one a ``CHECK_RESTART_ROWS`` rows.  A
    restart re-walks at most two chunks of ``CHECK_ROWS``, so restarts
    re-walk at most about n / 8 + 8,192 rows before the host-order fold
    takes over: the worst case stays near one fold of the n rows."""
    return CHECK_SPARE_RESTARTS + -(-n // CHECK_RESTART_ROWS)


def _check_guess(guess: torch.Tensor, n: int, W: int, dev) -> None:
    if guess.dtype != torch.int64 or guess.shape != (n + 1,):
        raise ValueError(f"guess must be int64 [{n + 1}], got {guess.dtype} "
                         f"{tuple(guess.shape)}")
    if guess.device != dev or not guess.is_contiguous():
        raise ValueError(f"guess must be contiguous on {dev}")
    jp = torch.arange(1, n + 1, device=dev)
    if not bool(((guess[1:] >= jp - jp.clamp(max=W)) & (guess[1:] < jp)).all()):
        raise ValueError("guess[jp] must lie in [jp - min(W, jp), jp) for jp >= 1")


def dp_recurrence_checked_plain(S: torch.Tensor, guess: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain checked fold: the kernel's walk, chunks of ``CHECK_ROWS``,
    restarts and budget (:func:`check_budget`), the walk and the fixes on
    Python floats (IEEE f64), each chunk's check in torch ops on the CPU;
    ``(prev, opt, stats)`` bitwise the kernel's on any finite S and valid
    guess (``stats``: restarts, rows re-walked, rows of the host-order
    fold)."""
    n, W = S.shape
    dev = S.device
    if n == 0:
        return (torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.float64, device=dev),
                torch.zeros(3, dtype=torch.int64, device=dev))
    C, budget = CHECK_ROWS, check_budget(n)
    We, K = min(W, n), -(-n // C)
    Sc = S.cpu()
    rows = torch.arange(1, n + 1)
    width = rows - guess.cpu()[1:]
    d = [0] + width.tolist()
    s = [0.0] + Sc[rows - 1, width - 1].tolist()  # each row's walked entry
    v = [0.0] * (n + 1)

    def end(c):
        return min((c + 1) * C, n)

    def walk(a, b):
        for jp in range(a, b + 1):
            v[jp] = v[jp - d[jp]] + s[jp]

    def host_row(r):  # H(v)[r] and its width, the host's order
        best, bw = INF, 1
        for w, x in enumerate(Sc[r - 1, :min(We, r)].tolist(), 1):
            c = v[r - w] + x
            if c < best:
                best, bw = c, w
        return best, bw

    def first_fail(c):  # the first row of chunk c with v != H(v) or d != P(v)
        lo, hi = c * C + 1, end(c)
        base = lo - We
        vt = torch.tensor([INF] * max(0, -base) + v[max(base, 0):hi + 1],
                          dtype=torch.float64)
        jp = torch.arange(lo, hi + 1)
        cand = vt[jp[:, None] - torch.arange(1, We + 1) - base] + Sc[lo - 1:hi, :We]
        best, arg = cand.min(1).values, cand.argmin(1)  # argmin: the first
        bad = ((arg + 1 != torch.tensor(d[lo:hi + 1]))
               | (vt[jp - base] != best)).nonzero()
        return lo + int(bad[0]) if bad.numel() else None

    walk(1, end(0))
    k = restarts = rewalked = folded = 0
    while k < K:
        if k + 1 < K:
            walk((k + 1) * C + 1, end(k + 1))
        r = first_fail(k)
        if r is None:
            k += 1
            continue
        v[r], d[r] = host_row(r)
        if restarts == budget:  # the host-order fold from r + 1
            for jp in range(r + 1, n + 1):
                v[jp], d[jp] = host_row(jp)
            folded = n - r
            break
        restarts += 1
        rewalked += end(k) - r + (end(k + 1) - (k + 1) * C if k + 1 < K else 0)
        walk(r + 1, end(k))
    prev = [0] + [jp - d[jp] for jp in range(1, n + 1)]
    return (torch.tensor(prev, dtype=torch.int64, device=dev),
            torch.tensor(v, dtype=torch.float64, device=dev),
            torch.tensor([restarts, rewalked, folded], dtype=torch.int64, device=dev))


def dp_recurrence_checked(S: torch.Tensor, guess: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dp_recurrence` by the checked speculative fold
    (``csrc/dp_checked.cu``): ``guess`` ``[n + 1]`` int64 back pointers
    (``jp - min(W, jp) <= guess[jp] < jp``; None: the scan's on ``S``,
    :func:`dp_recurrence_scan`) walked one add a row and held, a chunk of
    ``CHECK_ROWS`` rows at a time, to the host's first minimum; the first
    row that fails is set to it and the walk resumes there, up to
    :func:`check_budget` restarts, then the host-order fold finishes the
    rows in the same launch.  ``(prev, opt, stats)``: the serial fold's prev
    and opt bit for bit on any finite S, and int64 ``stats`` (restarts, rows
    re-walked, rows folded) on S's device."""
    _check_S(S)
    n, W = S.shape
    dev = S.device
    if n >= 1 << 30:
        raise ValueError(f"the checked fold takes fewer than 2^30 rows, got {n}")
    if guess is None:
        guess = dp_recurrence_scan(S)[0]
    else:
        _check_guess(guess, n, W, dev)
    if dev.type == "cpu":
        return dp_recurrence_checked_plain(S, guess)
    opt = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    prev = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    if n == 0:
        return prev, opt, stats
    _lib.launch(dp_recurrence_checked, "vbcs_dp_recurrence_checked", dev, n, W,
                CHECK_ROWS, check_budget(n), S.data_ptr(), guess.data_ptr(),
                opt.data_ptr(), prev.data_ptr(), stats.data_ptr())
    return prev, opt, stats


def chain_floor_plain(s: torch.Tensor, n: int) -> torch.Tensor:
    """Plain :func:`chain_floor`, on Python floats."""
    v, x = s.tolist(), 0.0
    for i in range(n):
        x = min(v[8], x + v[i % 8])
    return torch.tensor([x], dtype=torch.float64, device=s.device)


def chain_floor(s: torch.Tensor, n: int) -> torch.Tensor:
    """``[x]`` after ``n`` steps of ``x = min(s[8], x + s[i % 8])`` from 0:
    the serial fold's dependent path alone (an add and a min on the value
    just made, nothing read from memory), whose time is the floor of
    ``n`` steps of :func:`dp_recurrence_serial`.  ``s`` f64 ``[9]``; ``n`` a
    multiple of 8."""
    if s.dtype != torch.float64 or s.shape != (9,) or not s.is_contiguous():
        raise ValueError("s must be a contiguous float64 tensor of 9")
    if n < 0 or n % 8:
        raise ValueError(f"n must be a non-negative multiple of 8, got {n}")
    if s.device.type == "cpu":
        return chain_floor_plain(s, n)
    if s.device.type != "cuda":
        raise NotImplementedError(f"no DP kernel for device {s.device}")
    out = torch.empty(1, dtype=torch.float64, device=s.device)
    _lib.launch(chain_floor, "vbcs_dp_chain_floor", s.device, n, s.data_ptr(),
                out.data_ptr())
    return out


dp_table.launches = 0
dp_recurrence_serial.launches = 0
dp_recurrence_scan.launches = 0
dp_recurrence_checked.launches = 0
chain_floor.launches = 0
