"""The split-point DP on a torch device: ``DynamicTotalChunker``'s plan
without the host's column loop.

Counterpart of ``vbcs_tpu/plan/jax_dp.py`` (:data:`COUNTERPARTS`), which
runs the DP as a ``lax.scan`` so that a partition can be planned inside a
jit trace, without a host round trip.  Here the cores (:func:`dp_prev`)
take the CSC's arrays as tensors already on the device and return ``prev``
and ``opt`` there: the previous occurrence of each nonzero's group (torch
ops), the stripe-cost table (a kernel, one thread a column) and the
recurrence (a kernel: one thread walks the n dependent steps, the others
load its rows and recover the back pointers).  The wrappers backtrack
``prev`` on the host, as the JAX ones do.

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

import numpy as np
import torch

from ..formats.csc import CSC
from ..formats.partition import SplitPartition
from ..models.cost import (BlockComponentCostModel,
                           ColumnBlockComponentCostModel)
from ..ops.dp import dp_recurrence, dp_table, prev_occurrence
from .dynamic import _native_tables, _row_weights

__all__ = ["dp_prev", "dp_inputs", "dp_partition_device",
           "dp_partition_device_2d", "COUNTERPARTS"]

# every public function of vbcs_tpu/plan/jax_dp.py -> its port
COUNTERPARTS = {
    "dp_partition_jit": "dp_partition_device",
    "dp_partition_jit_2d": "dp_partition_device_2d",
    "dp_partition_jax": "dp_prev",
    "dp_partition_jax_2d": "dp_prev",
}


def dp_prev(pos: torch.Tensor, grp: torch.Tensor, wts, alpha: torch.Tensor,
            beta: torch.Tensor, W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The DP's core on the tensors' device: ``(prev, opt)``, each ``[n + 1]``.

    ``pos`` ``[n + 1]`` and ``grp`` ``[nnz]`` int64 (the CSC's pointers and
    each nonzero's group: its row, or its row-block in 2-D); ``wts`` None
    (unit weights, one counter) or ``[R, groups]`` f64; ``alpha`` ``[W]``
    and ``beta`` ``[R, W]`` f64, the models' tables, all finite
    (:func:`dp_inputs` builds them).  ``prev[jp]`` is the start of the last
    stripe of the best plan of columns ``[0, jp)``."""
    _check_width(W)
    S = dp_table(pos, grp, prev_occurrence(pos, grp), wts, alpha, beta, W)
    return dp_recurrence(S)


def _backtrack(prev: list, n: int) -> SplitPartition:
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


def dp_inputs(A: CSC, model, W: int, Pi: SplitPartition | None = None, *,
              device) -> tuple:
    """``(pos, grp, wts, alpha, beta)`` for :func:`dp_prev` on ``device``:
    a :class:`ColumnBlockComponentCostModel` counts rows (``wts`` None, one
    counter; ``Pi`` must be None), a :class:`BlockComponentCostModel` the
    row-blocks of ``Pi`` (default: every row a block), weighted by
    ``beta_row``.  Raises ``TypeError`` for any other model and
    ``ValueError`` for a table that is not finite."""
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
    idx = _tensor(A.idx, np.int64, device)
    grp = idx if wts is None else _tensor(Pi.to_map().asg, np.int64, device)[idx]
    return (_tensor(A.pos, np.int64, device), grp,
            None if wts is None else _tensor(wts, np.float64, device),
            _tensor(alpha, np.float64, device), _tensor(beta, np.float64, device))


def _solve(A: CSC, model, W: int, Pi, device) -> SplitPartition:
    inputs = dp_inputs(A, model, W, Pi, device=device)
    if A.n == 0:
        return SplitPartition.whole(0)
    prev, _ = dp_prev(*inputs, W)
    return _backtrack(prev.cpu().tolist(), A.n)


def dp_partition_device(A: CSC, model: ColumnBlockComponentCostModel, W: int,
                        *, device) -> SplitPartition:
    """The optimal 1-D column partition (stripes of width <= ``W``) under
    ``model``, planned on ``device``: ``plan/dynamic.dp_partition``'s."""
    if not isinstance(model, ColumnBlockComponentCostModel):
        raise TypeError(f"dp_partition_device takes a ColumnBlockComponentCostModel, "
                        f"got {type(model).__name__}")
    return _solve(A, model, W, None, device)


def dp_partition_device_2d(A: CSC, model: BlockComponentCostModel, W: int,
                           Pi: SplitPartition | None = None, *,
                           device) -> SplitPartition:
    """The 2-D column pass on ``device``: the optimal column partition
    under ``model`` with the row partition ``Pi`` fixed (default: every row
    a block), ``plan/dynamic.dp_partition``'s with ``row_partition=Pi``."""
    if not isinstance(model, BlockComponentCostModel):
        raise TypeError(f"dp_partition_device_2d takes a BlockComponentCostModel, "
                        f"got {type(model).__name__}")
    return _solve(A, model, W, Pi, device)
