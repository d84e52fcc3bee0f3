"""Chain TrSpMV: ``y = (alpha * A.T)^n_iters @ x`` on a square VBC1DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv3.py``'s chain path
(``tr_spmv_chain3``; Pallas kernel ``_chain_kernel``).  On a CUDA tensor
:func:`tr_spmv_chain` makes one cooperative launch of
``csrc/chain.cu``, a persistent kernel whose blocks each hold a
contiguous range of stripes (:func:`chain_plan`) in shared memory and run
every iteration from there, a thread per group of 4 columns, gathering x
from a window of it staged in shared memory, with a grid barrier between
iterations; on a CPU tensor it runs :func:`tr_spmv_chain_plain`, a loop
of the plain TrSpMV.

``alpha`` scales every iteration (``None`` is 1), as in the JAX kernel.
A chain longer than ``MAX_LAUNCH_ITERS`` iterations (the C launcher's
``int``) runs as several launches, each applying ``alpha``, so any
``n_iters`` gives the JAX operator's result.

``perm`` runs an auto-RCM operator's chain (a pack of ``A[perm][:,
perm]``) from a natural x to a natural y in the same launches: the first
gathers ``x[perm]`` before its first iteration, the last stores column
``j`` at ``y[perm[j]]`` after its last (each a pass of the grid behind a
grid barrier), so the chain itself stays in permuted space, where the
RCM keeps its x windows short.
"""

from __future__ import annotations

import ctypes
import operator
from typing import NamedTuple

import torch

from ..formats.device import VBC1DDevice
from ..utils import trace
from . import _lib
from .trspmv import check_tensor, tr_spmv_plain

__all__ = ["tr_spmv_chain", "tr_spmv_chain_plain", "chain_plan", "chain_grid",
           "ChainPlan", "launch_iters", "MAX_LAUNCH_ITERS"]

# the most iterations one launch runs (the launcher's n_iters is a C int)
MAX_LAUNCH_ITERS = 2**31 - 1

# columns a thread takes together: one float4 of a stripe's value row
# (csrc/chain.cu: kCols)
GROUP = 4
# a resident stripe's values start where its first column does, modulo
# ALIGN words: a float4 of a width-4k row is aligned, and the 32 adjacent
# columns a quarter-warp reads as float4s fall in 32 banks
ALIGN = 32
# a column's weight in the partition, in stored values: its store and the
# loop around its blocks, so runs of empty or narrow stripes still count
COLUMN_WEIGHT = 2
_grids: dict = {}  # CUDA device index -> the default launch's (blocks, budget)


def _check_chain(fmt, n_iters: int) -> int:
    """``n_iters`` as an int; raises for a non-square ``fmt`` or a count
    below 1 or a natural view (the chain runs a relabeled pack in its
    own order, between two gathers)."""
    n_iters = operator.index(n_iters)
    if fmt.m != fmt.n:
        raise ValueError(f"the chain needs a square matrix, got {fmt.m}x{fmt.n}")
    if fmt.col_out is not None:
        raise ValueError("the chain takes a pack in its own order, not a natural view")
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    return n_iters


class ChainPlan(NamedTuple):
    """The chain kernel's partition of a pack over ``G`` blocks (int32, on
    the pack's device).  ``buf`` holds the other fields back to back, in
    this order, and is what the kernel reads; the fields are views of it.

    Block ``k`` owns stripes ``lo[k]:lo[k + 1]`` and holds ``lo[k]:res[k]``
    of them resident in shared memory: their values (stripe ``s``'s start
    at ``spl[s] - spl[lo[k]] + pad[s] - pad[lo[k]]`` words, ``pad`` a
    multiple of ``ALIGN``, so column ``j``'s values start at ``j -
    spl[lo[k]]`` modulo ``ALIGN``) and block rows.  Where ``win[k]`` is
    not 0 it stages ``x[win_lo[k]:win_lo[k] + win[k]]``, every row its
    stripes read, in shared memory each iteration.  Its threads take the
    column groups ``glo[k]:glo[k + 1]``: up to ``GROUP`` adjacent columns
    of one stripe, the first at ``gcol[g]``."""

    buf: torch.Tensor
    lo: torch.Tensor  # [G + 1]
    res: torch.Tensor  # [G]
    win_lo: torch.Tensor  # [G]
    win: torch.Tensor  # [G]
    glo: torch.Tensor  # [G + 1]
    pad: torch.Tensor  # [L + 1]
    gcol: torch.Tensor  # [column groups]


def chain_plan(fmt: VBC1DDevice, blocks: int, budget: int) -> ChainPlan:
    """The chain kernel's partition of ``fmt`` over ``blocks`` blocks with
    ``budget`` bytes of shared memory each (:class:`ChainPlan`).

    Block ``k`` takes the stripes whose start, in stored values plus
    ``COLUMN_WEIGHT`` per column, falls in ``[k, k + 1) * total /
    blocks``, so no block's load exceeds the mean by more than one
    stripe.  A block whose whole range fits the budget holds it, and
    stages its x window too where that still fits; any other block holds
    the longest prefix of its range that fits.  Computed with torch ops
    once per (format, blocks, budget) and cached on the format
    (``fmt.chain_plans``)."""
    if blocks < 1 or budget < 0:
        raise ValueError(f"need blocks >= 1 and budget >= 0, got {blocks}, {budget}")
    key = (blocks, budget)
    plan = fmt.chain_plans.get(key)
    if plan is None:
        spl, pos, ofs = fmt.spl.long(), fmt.pos.long(), fmt.ofs.long()
        dev = ofs.device
        widths = spl[1:] - spl[:-1]
        cost = (ofs[1:] - ofs[:-1]) + COLUMN_WEIGHT * widths
        start = torch.cumsum(cost, 0) - cost  # each stripe's, exclusive
        total = cost.sum()
        k = torch.arange(blocks + 1, device=dev)
        lo = torch.searchsorted(start * blocks, k * total)
        lo[-1] = fmt.L
        # the block rows each block reads: its x window
        owner = torch.repeat_interleave(
            torch.arange(blocks, device=dev), pos[lo[1:]] - pos[lo[:-1]],
            output_size=fmt.idx.numel())
        rows = fmt.idx.long()
        first = torch.full((blocks,), fmt.m, device=dev).scatter_reduce_(
            0, owner, rows, "amin")
        last = torch.full((blocks,), -1, device=dev).scatter_reduce_(
            0, owner, rows, "amax")
        # each resident stripe starts where its first column does, modulo
        # ALIGN: after its first value row, a multiple of ALIGN words
        pad = _exclusive_cumsum(ALIGN * torch.div(
            ofs[1:] - ofs[:-1] - widths + ALIGN - 1, ALIGN,
            rounding_mode="floor").clamp(min=0))
        # shared bytes before each stripe boundary: padded values, block rows
        resident = 4 * (spl + pad + pos)
        # the window is staged where it fits beside the whole range
        win = (last - first + 1).clamp(min=0)
        win = torch.where(resident[lo[1:]] - resident[lo[:-1]] + 4 * win <= budget,
                          win, 0)
        res = torch.searchsorted(resident, resident[lo[:-1]] + budget - 4 * win,
                                 right=True) - 1
        # column groups: GROUP adjacent columns of a stripe
        ngroups = torch.div(widths + GROUP - 1, GROUP, rounding_mode="floor")
        gofs = _exclusive_cumsum(ngroups)
        n_groups = int(gofs[-1])
        gstripe = torch.repeat_interleave(torch.arange(fmt.L, device=dev), ngroups,
                                          output_size=n_groups)
        gcol = spl[gstripe] + GROUP * (torch.arange(n_groups, device=dev)
                                       - gofs[gstripe])
        parts = [lo, torch.minimum(res, lo[1:]), torch.where(win > 0, first, 0),
                 win, gofs[lo], pad, gcol]
        buf = torch.cat(parts).int()
        plan = ChainPlan(buf, *torch.split(buf, [p.numel() for p in parts]))
        fmt.chain_plans[key] = plan
    return plan


def launch_iters(n_iters: int):
    """The iteration counts of the launches a chain of ``n_iters`` makes:
    ``MAX_LAUNCH_ITERS`` each, then the rest (a generator)."""
    full, rest = divmod(operator.index(n_iters), MAX_LAUNCH_ITERS)
    for _ in range(full):
        yield MAX_LAUNCH_ITERS
    if rest:
        yield rest


def _exclusive_cumsum(t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    torch.cumsum(t, 0, out=out[1:])
    return out


def chain_grid(device, budget: int = -1) -> tuple[int, int]:
    """``(blocks, budget)`` of a cooperative chain launch on the CUDA
    ``device``: every block the occupancy API fits at ``budget`` bytes of
    shared memory a block (``-1``: the largest a block may take).  Raises
    ``RuntimeError`` for a budget over the device's limit."""
    b, n = ctypes.c_int(budget), ctypes.c_int(0)
    _lib.launch(None, "vbcs_chain_grid", device, ctypes.byref(b), ctypes.byref(n),
                name="tr_spmv_chain grid")
    return n.value, b.value


def _check_perm(perm, fmt) -> None:
    if perm is None:
        return
    if not isinstance(perm, torch.Tensor) or perm.dtype != torch.int32:
        raise TypeError("perm must be an int32 tensor")
    if perm.shape != (fmt.n,) or perm.device != fmt.device or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous [{fmt.n}] tensor on {fmt.device}")


def _unpermute(y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[perm[j]] = y[j]``: a result in permuted space, in natural order."""
    out = torch.empty_like(y)
    out[perm.long()] = y
    return out


def tr_spmv_chain_plain(fmt: VBC1DDevice, x: torch.Tensor, n_iters: int,
                        alpha=None, perm=None) -> torch.Tensor:
    """Plain PyTorch chain: ``n_iters`` calls of :func:`tr_spmv_plain`,
    each scaled by ``alpha``; with ``perm``, from ``x[perm]`` and out to
    ``y[perm] = chain``."""
    n_iters = _check_chain(fmt, n_iters)
    _check_perm(perm, fmt)
    if perm is not None:
        x = x[perm.long()]
    for _ in range(n_iters):
        x = tr_spmv_plain(fmt, x, alpha)
    return x if perm is None else _unpermute(x, perm)


def tr_spmv_chain(fmt: VBC1DDevice, x: torch.Tensor, n_iters: int,
                  alpha=None, perm=None) -> torch.Tensor:
    """``(alpha * A.T)^n_iters @ x`` in natural order, shape ``[n]``, for a
    square ``fmt`` and ``n_iters >= 1``; with ``perm`` (int32 ``[n]``, a
    permutation: unchecked on the card), the chain of an operator of
    ``A`` whose ``fmt`` packs ``A[perm][:, perm]``:
    ``y[perm] = (alpha * fmt.T)^n_iters @ x[perm]``.

    CUDA tensors run the persistent chain kernel in one cooperative launch
    for every ``MAX_LAUNCH_ITERS`` iterations (:func:`launch_iters`), over
    every block the card holds at the largest shared-memory size (a
    refused launch raises ``RuntimeError``); each launch reads the last
    one's output and writes the other of two hand-over buffers, so the
    last launch writes the result; the first launch gathers x through
    ``perm`` and the last stores through it.  CPU tensors run
    :func:`tr_spmv_chain_plain` over the same split."""
    n_iters = _check_chain(fmt, n_iters)
    dev = fmt.device
    check_tensor("x", x, (fmt.m,), dev)
    _check_perm(perm, fmt)
    if dev.type == "cpu":
        if perm is not None:
            x = x[perm.long()]  # the first launch's gather pass
        for k in launch_iters(n_iters):
            x = tr_spmv_chain_plain(fmt, x, k, alpha)
        return x if perm is None else _unpermute(x, perm)  # the last's store pass
    if dev.type != "cuda":
        raise NotImplementedError(f"no chain kernel for device {dev}")
    out = torch.empty(fmt.n, dtype=torch.float32, device=dev)
    if fmt.n == 0:
        return out
    if dev.index not in _grids:
        _grids[dev.index] = chain_grid(dev)
    blocks, budget = _grids[dev.index]
    plan = chain_plan(fmt, blocks, budget)
    bufs = (torch.empty(2, fmt.n, dtype=torch.float32, device=dev)
            if n_iters > 1 or perm is not None else None)
    n_launches = -(-n_iters // MAX_LAUNCH_ITERS)
    # launch j writes ends[(n_launches - 1 - j) % 2]: the last one, out
    ends = (out, torch.empty_like(out) if n_launches > 1 else None)
    count = torch.empty(1, dtype=torch.int32, device=dev)  # the grid barrier's
    src = x
    for j, k in enumerate(launch_iters(n_iters)):
        dst = ends[(n_launches - 1 - j) % 2]
        x_map = perm if j == 0 else None
        y_map = perm if j == n_launches - 1 else None
        with trace.span("op.launch"):
            _lib.launch(tr_spmv_chain, "vbcs_tr_spmv_chain", dev, k, fmt.L,
                        plan.buf.data_ptr(), fmt.spl.data_ptr(), fmt.pos.data_ptr(),
                        fmt.idx.data_ptr(), fmt.ofs.data_ptr(), fmt.col_stripe.data_ptr(),
                        fmt.val.data_ptr(), src.data_ptr(),
                        1.0 if alpha is None else float(alpha),
                        None if bufs is None else bufs[0].data_ptr(),
                        None if bufs is None else bufs[1].data_ptr(), dst.data_ptr(),
                        _lib.ptr(x_map), _lib.ptr(y_map), count.data_ptr(), 0, blocks,
                        budget)
        src = dst
    return out


tr_spmv_chain.launches = 0
