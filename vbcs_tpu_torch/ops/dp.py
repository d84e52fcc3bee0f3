"""The split-point DP's two kernels: the stripe-cost table and the recurrence.

Counterpart of ``vbcs_tpu/plan/jax_dp.py``'s cores (``dp_partition_jax``,
``dp_partition_jax_2d``: one ``lax.scan`` over the columns).  The port
splits what the scan computes into its parallel part and its chain:

* :func:`prev_occurrence` (torch ops, any device): for each nonzero, the
  column of the previous nonzero of its group in column-major order, or
  -1 (a stable sort by group);
* :func:`dp_table` (``csrc/dp.cu`` on a CUDA tensor): ``S[jp - 1, w - 1]``,
  the cost of the stripe of columns ``[jp - w, jp)``, from the host DP's
  counters replayed over the W columns before ``jp`` (inf where ``w > jp``);
* :func:`dp_recurrence` (``csrc/dp.cu``): ``opt[jp] = min_w opt[jp - w] +
  S[jp - 1, w - 1]`` and the back pointers ``prev``, the narrowest stripe
  winning ties;
* :func:`chain_floor` (``csrc/dp.cu``): the recurrence's dependent path
  alone, a measurement of the floor of its n steps (not on the DP's path).

Both compute in f64 in the order of the C++ DP (``native/vbc_native.cpp``
``dp_partition``), so the split points are that DP's bit for bit.  On a
CPU tensor each wrapper runs its plain version (:func:`dp_table_plain`,
:func:`dp_recurrence_plain`); on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["prev_occurrence", "dp_table", "dp_table_plain", "dp_recurrence",
           "dp_recurrence_plain", "chain_floor", "chain_floor_plain"]

INF = float("inf")


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
    lib = _lib.load()
    # the counter windows go to device memory when shared memory cannot
    # hold them; the kernel's source decides
    k = lib.vbcs_dp_table_scratch_doubles(n, W, R)
    scratch = torch.empty(k, dtype=torch.float64, device=dev) if k else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vbcs_dp_table(
            n, W, R, 0 if wts is None else wts.shape[1], pos.data_ptr(),
            grp.data_ptr(), prevcol.data_ptr(),
            None if wts is None else wts.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), S.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    _lib.check(lib, rc, "dp_table")
    dp_table.launches += 1
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


def dp_recurrence(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(prev, opt)``, each ``[n + 1]`` (int64, f64), from ``S`` ``[n, W]``
    f64: ``opt[0] = 0``, ``opt[jp] = min_{w <= min(W, jp)} opt[jp - w] +
    S[jp - 1, w - 1]`` and ``prev[jp]`` the ``jp - w`` of the first
    minimum over ascending ``w`` (``jp - 1`` when ``opt[jp]`` is inf)."""
    if S.dtype != torch.float64 or S.dim() != 2 or not S.is_contiguous():
        raise ValueError("S must be a contiguous 2-D float64 tensor")
    n, W = S.shape
    if W < 1:
        raise ValueError(f"width cap W must be >= 1, got {W}")
    dev = S.device
    if dev.type == "cpu":
        return dp_recurrence_plain(S)
    if dev.type != "cuda":
        raise NotImplementedError(f"no DP kernel for device {dev}")
    opt = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    prev = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        return prev, opt
    lib = _lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vbcs_dp_recurrence(n, W, S.data_ptr(), opt.data_ptr(),
                                    prev.data_ptr(), stream)
    _lib.check(lib, rc, "dp_recurrence")
    dp_recurrence.launches += 1
    return prev, opt


def chain_floor_plain(s: torch.Tensor, n: int) -> torch.Tensor:
    """Plain :func:`chain_floor`, on Python floats."""
    v, x = s.tolist(), 0.0
    for i in range(n):
        x = min(v[8], x + v[i % 8])
    return torch.tensor([x], dtype=torch.float64, device=s.device)


def chain_floor(s: torch.Tensor, n: int) -> torch.Tensor:
    """``[x]`` after ``n`` steps of ``x = min(s[8], x + s[i % 8])`` from 0:
    the recurrence's dependent path alone (an add and a min on the value
    just made, nothing read from memory), whose time is the floor of
    ``n`` steps of :func:`dp_recurrence`.  ``s`` f64 ``[9]``; ``n`` a
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
    lib = _lib.load()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = lib.vbcs_dp_chain_floor(n, s.data_ptr(), out.data_ptr(), stream)
    _lib.check(lib, rc, "chain_floor")
    chain_floor.launches += 1
    return out


dp_table.launches = 0
dp_recurrence.launches = 0
chain_floor.launches = 0
