"""The split-point DP on a torch device: ``DynamicTotalChunker``'s plan
without the host's column loop.

Counterpart of ``vbcs_tpu/plan/jax_dp.py`` (:data:`COUNTERPARTS`), which
runs the DP as a ``lax.scan`` so that a partition can be planned inside a
jit trace, without a host round trip.  Here the cores (:func:`dp_prev`)
take the CSC's arrays as tensors already on the device and return ``prev``
and ``opt`` there: the previous occurrence of each nonzero's group (torch
ops), the stripe-cost table (a kernel, one thread a column, a block's
columns staged once) and the recurrence, by one of two routes: a parallel
(min,+) scan where the model's tables are exact (every sum exact in f64:
the memory models, binary fractions), otherwise (fitted time models) the
checked fold, the scan's back pointers walked one add a row and checked
against the host's order of sums a chunk behind.  The wrappers backtrack
``prev`` on the device by pointer doubling and copy the split points to the
host once (the JAX ones backtrack on the host).

The split points are those of ``plan/dynamic.dp_partition`` (the C++ DP)
bit for bit, the narrowest stripe winning ties, for the two models the
JAX functions take: :class:`ColumnBlockComponentCostModel` (1-D) and
:class:`BlockComponentCostModel` under a row partition ``Pi`` (2-D).  Two
deliberate differences from the JAX version: the port computes in f64
in the C++ DP's order (the JAX scan sums in f32, and the order of f64
sums flips ties on fitted cost tables: ``native/vbc_native.cpp``), and it
reads the CSC as it is (the JAX scan pads every column to the longest
one).  A 2-D column's repeated row-blocks are not merged: the C++ DP
subtracts and adds them at that column, and so does the table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..formats.csc import CSC
from ..formats.partition import SplitPartition
from ..models.cost import (BlockComponentCostModel,
                           ColumnBlockComponentCostModel)
from ..ops.dp import dp_recurrence, dp_table, exact_tables, prev_occurrence
from .dynamic import _native_tables, _row_weights

__all__ = ["dp_prev", "dp_inputs", "dp_route", "backtrack", "dp_partition_device",
           "dp_partition_device_2d", "dp_stages", "STAGES", "COUNTERPARTS"]

# the stages of a device plan that dp_stages times apart
STAGES = ("inputs", "prev_occurrence", "table", "recurrence", "backtrack")

# every public function of vbcs_tpu/plan/jax_dp.py -> its port
COUNTERPARTS = {
    "dp_partition_jit": "dp_partition_device",
    "dp_partition_jit_2d": "dp_partition_device_2d",
    "dp_partition_jax": "dp_prev",
    "dp_partition_jax_2d": "dp_prev",
}


def dp_prev(pos: torch.Tensor, grp: torch.Tensor, wts, alpha: torch.Tensor,
            beta: torch.Tensor, exact: bool, W: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The DP's core on the tensors' device: ``(prev, opt)``, each ``[n + 1]``.

    ``pos`` ``[n + 1]`` and ``grp`` ``[nnz]`` int64 (the CSC's pointers and
    each nonzero's group: its row, or its row-block in 2-D); ``wts`` None
    (unit weights, one counter) or ``[R, groups]`` f64; ``alpha`` ``[W]``
    and ``beta`` ``[R, W]`` f64, the models' tables, all finite; ``exact``
    whether every sum is exact (the scan's route).  :func:`dp_inputs`
    builds them all.  ``prev[jp]`` is the start of the last stripe of the
    best plan of columns ``[0, jp)``."""
    _check_width(W)
    S = dp_table(pos, grp, prev_occurrence(pos, grp), wts, alpha, beta, W)
    return dp_recurrence(S, exact)


def backtrack(prev: torch.Tensor) -> SplitPartition:
    """The split points of ``prev`` ``[n + 1]`` (``prev[0] = 0``, ``prev[j]
    < j``): ``n, prev[n], prev[prev[n]], ..., 0`` ascending.  Pointer
    doubling on ``prev``'s device: ``jump[b] = prev^(2^b)`` for
    ``2^b <= n``, the number of steps to 0 by binary lifting, then every
    split point at once from the bits of its distance to ``n``; one copy of
    the split points to the host."""
    n = prev.numel() - 1
    if n == 0:
        return SplitPartition.whole(0)
    jumps = [prev]
    for _ in range(n.bit_length() - 1):
        jumps.append(jumps[-1][jumps[-1]])
    x = torch.tensor(n, device=prev.device)
    steps = torch.tensor(1, device=prev.device)
    for b in reversed(range(len(jumps))):
        y = jumps[b][x]
        go = y != 0
        x = torch.where(go, y, x)
        steps = steps + go * (1 << b)
    k = torch.arange(int(steps) + 1, device=prev.device)
    at = torch.full_like(k, n)
    for b, jump in enumerate(jumps):
        at = torch.where((k >> b) & 1 == 1, jump[at], at)
    return SplitPartition(at.flip(0).cpu().numpy())


def _backtrack(prev: list, n: int) -> SplitPartition:
    """The host loop over ``prev`` (a list): :func:`backtrack`'s oracle."""
    splits = [n]
    j = n
    while j > 0:
        j = prev[j]
        splits.append(j)
    splits.reverse()
    return SplitPartition(np.asarray(splits, dtype=np.int64))


def _check_width(W: int) -> None:
    if W < 1:
        raise ValueError(f"width cap W must be >= 1, got {W}")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _host_tables(A: CSC, model, W: int, Pi):
    """``(Pi, wts, alpha, beta)`` on the host, the checks of :func:`dp_inputs`."""
    _check_width(W)
    if isinstance(model, ColumnBlockComponentCostModel):
        if Pi is not None:
            raise ValueError("a 1-D model takes no row partition")
        wts = None
    elif isinstance(model, BlockComponentCostModel):
        Pi = Pi if Pi is not None else SplitPartition.trivial(A.m)
        wts = _row_weights(model, Pi.widths().astype(np.int64))
    else:
        raise TypeError("the device DP takes a ColumnBlockComponentCostModel or "
                        f"a BlockComponentCostModel, got {type(model).__name__}")
    alpha, beta, _ = _native_tables(model, W)
    for name, t in (("alpha", alpha), ("beta", beta), ("beta_row", wts)):
        if t is not None and not np.isfinite(t).all():
            raise ValueError(f"the model's {name} table is not finite")
    return Pi, wts, alpha, beta


def dp_route(A: CSC, model, W: int, Pi: SplitPartition | None = None) -> str:
    """The recurrence a plan of ``A`` under ``model`` takes: ``"scan"``
    where the tables are exact (:func:`~vbcs_tpu_torch.ops.dp.exact_tables`),
    else ``"checked"`` (on a CUDA device the checked fold on the scan's
    back pointers, on the CPU the host loop); decided on the host."""
    _, wts, alpha, beta = _host_tables(A, model, W, Pi)
    return "scan" if exact_tables(alpha, beta, wts, A.m, A.n) else "checked"


def dp_inputs(A: CSC, model, W: int, Pi: SplitPartition | None = None, *,
              device) -> tuple:
    """``(pos, grp, wts, alpha, beta, exact)`` for :func:`dp_prev` on
    ``device`` (``exact`` a bool, :func:`~vbcs_tpu_torch.ops.dp.exact_tables`
    of the tables, decided on the host): a
    :class:`ColumnBlockComponentCostModel` counts rows (``wts`` None, one
    counter; ``Pi`` must be None), a :class:`BlockComponentCostModel` the
    row-blocks of ``Pi`` (default: every row a block), weighted by
    ``beta_row``.  Raises ``TypeError`` for any other model and
    ``ValueError`` for a table that is not finite."""
    Pi, wts, alpha, beta = _host_tables(A, model, W, Pi)
    exact = exact_tables(alpha, beta, wts, A.m, A.n)
    idx = _tensor(A.idx, np.int64, device)
    grp = idx if wts is None else _tensor(Pi.to_map().asg, np.int64, device)[idx]
    return (_tensor(A.pos, np.int64, device), grp,
            None if wts is None else _tensor(wts, np.float64, device),
            _tensor(alpha, np.float64, device), _tensor(beta, np.float64, device),
            exact)


def _solve(A: CSC, model, W: int, Pi, device, stages=None) -> SplitPartition:
    """The plan; with ``stages`` a dict, each stage of :data:`STAGES` ends
    in a synchronize and its host ms is recorded there, with the route
    that ran (``"scan"``, ``"checked"``, or ``"host"``: the host loop a CPU
    device runs where :func:`dp_route` says ``"checked"``) and the checked
    fold's counters (``restarts``, ``rewalked``, ``folded``: 0 on the other
    routes)."""
    device = torch.device(device)
    t = [time.perf_counter()]

    def lap(name):
        if stages is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            stages[name] = (now - t[0]) * 1e3
            t[0] = now

    pos, grp, wts, alpha, beta, exact = dp_inputs(A, model, W, Pi, device=device)
    if stages is not None:
        stages["route"] = ("scan" if exact else
                           "host" if device.type == "cpu" else "checked")
    lap("inputs")
    if A.n == 0:
        return SplitPartition.whole(0)
    prevcol = prev_occurrence(pos, grp)
    lap("prev_occurrence")
    S = dp_table(pos, grp, prevcol, wts, alpha, beta, W)
    lap("table")
    prev, _ = dp_recurrence(S, exact, stats=stages)
    lap("recurrence")
    out = backtrack(prev)
    lap("backtrack")
    return out


def dp_stages(A: CSC, model, W: int, Pi: SplitPartition | None = None, *,
              device) -> tuple[SplitPartition, dict]:
    """:func:`dp_partition_device` (``Pi`` None) or
    :func:`dp_partition_device_2d`'s plan and the host ms of each of its
    :data:`STAGES`, each ended by a synchronize, with the route that ran
    and the checked fold's counters (``restarts``, ``rewalked``,
    ``folded``)."""
    stages = {}
    return _solve(A, model, W, Pi, device, stages), stages


def dp_partition_device(A: CSC, model: ColumnBlockComponentCostModel, W: int,
                        *, device="cuda") -> SplitPartition:
    """The optimal 1-D column partition (stripes of width <= ``W``) under
    ``model``, planned on ``device``: ``plan/dynamic.dp_partition``'s."""
    if not isinstance(model, ColumnBlockComponentCostModel):
        raise TypeError(f"dp_partition_device takes a ColumnBlockComponentCostModel, "
                        f"got {type(model).__name__}")
    return _solve(A, model, W, None, device)


def dp_partition_device_2d(A: CSC, model: BlockComponentCostModel, W: int,
                           Pi: SplitPartition | None = None, *,
                           device="cuda") -> SplitPartition:
    """The 2-D column pass on ``device``: the optimal column partition
    under ``model`` with the row partition ``Pi`` fixed (default: every row
    a block), ``plan/dynamic.dp_partition``'s with ``row_partition=Pi``."""
    if not isinstance(model, BlockComponentCostModel):
        raise TypeError(f"dp_partition_device_2d takes a BlockComponentCostModel, "
                        f"got {type(model).__name__}")
    return _solve(A, model, W, Pi, device)
