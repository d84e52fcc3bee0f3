"""Distributed SpMV and SpMM with a replicated dense operand.

Counterpart of ``vbcs_tpu/parallel/spmv.py``: ``shard_vbc`` and
``block_specs`` (one rank's part: :func:`shard_vbc`) and ``dist_tr_spmv``,
``dist_spmv``, ``dist_tr_spmm``, ``dist_spmm``.  The JAX version splits
each width class's block stream across the mesh and ``psum``s the
partial outputs; here each rank holds a contiguous range of the pack's
stripes (a column slice, balanced by stored values) and, with ``x`` or
``X`` whole on every rank:

* ``dist_tr_spmv`` runs the slice's own route (``operator.route_tr_spmv``:
  the stripe or the scatter kernel; ``route_tr_spmv_2d`` for a 2-D pack:
  the tile kernel or the stripe kernel on the 1-D view) for an f32 matrix
  and x, else ``ops/semiring.py`` in x's dtype, and the disjoint slices
  of ``y`` assemble in column order (one padded all-gather and a cut);
* ``dist_tr_spmm`` runs the SpMM kernel (``ops/spmm.py``) on the slice
  (its 1-D view for a 2-D pack), or the semiring SpMM, assembled alike;
* ``dist_spmv`` and ``dist_spmm`` run the forward product of the column
  slice with its rows of ``x`` (``ops/semiring.py``; the JAX package runs
  jnp there, no kernel) and sum the ranks' partial outputs with one
  ``all_reduce``, so their sums run in another order than one device's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..formats.device import SemiringDevice, VBC1DDevice
from ..operator import route_tr_spmv, route_tr_spmv_2d
from ..ops import semiring
from ..ops.spmm import tr_spmm
from . import comm
from .shard import split_ranges, stored_per_stripe
from .stream import StreamShard

__all__ = ["VBCShard", "shard_vbc", "dist_tr_spmv", "dist_spmv",
           "dist_tr_spmm", "dist_spmm"]


class VBCShard(StreamShard):
    """A :class:`~.stream.StreamShard` with the single-device operator's
    routes on its slice."""

    @property
    def is_f32(self) -> bool:
        return np.asarray(self.pack.val).dtype == np.float32

    @functools.cached_property
    def route(self):
        """``(name, fmt, call)`` of the slice's f32 TrSpMV, as the operator
        routes the whole pack."""
        if self.is_2d:
            return route_tr_spmv_2d(self.host, self.device, self.fmt)
        return route_tr_spmv(self.host, self.device)

    @functools.cached_property
    def spmm_fmt(self) -> VBC1DDevice:
        """The SpMM kernel's format of the slice (a 2-D slice's 1-D view)."""
        if self.is_2d:
            return self.fmt.view_1d()
        name, fmt, _ = self.route
        return fmt if name == "stripe" else self.fmt

    @functools.cached_property
    def semi(self) -> SemiringDevice:
        return SemiringDevice.from_host(self.host, device=self.device)

    def kernels_take(self, x: torch.Tensor) -> bool:
        return self.is_f32 and x.dtype == torch.float32

    def column_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole forward operand (``[n, ...]``)."""
        c0, c1 = self.col_starts[self.rank], self.col_starts[self.rank + 1]
        return x[int(c0):int(c1)]


def shard_vbc(B, *, device, group=None) -> VBCShard:
    """This rank's :class:`VBCShard` of a host pack (1-D or 2-D, this
    port's or the JAX package's, any dtype): stripe ranges balanced by
    stored values."""
    ndev, rank = comm.world(group)
    return VBCShard(rank=rank, ndev=ndev, pack=B,
                    ranges=split_ranges(stored_per_stripe(B), ndev),
                    device=torch.device(device), group=group)


def dist_tr_spmv(sh: VBCShard, x: torch.Tensor) -> torch.Tensor:
    """``y = A.T @ x`` (``[n]`` on every rank) for a whole ``x`` on every rank."""
    if sh.kernels_take(x):
        _, fmt, call = sh.route
        y = call(fmt, x)
    else:
        y = semiring.tr_spmv(sh.semi, x)
    return comm.gather_y(y, sh.widths, sh.group)


def dist_spmv(sh: VBCShard, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` (``[m]`` on every rank) for a whole ``x`` on every rank."""
    return comm.all_reduce(semiring.spmv(sh.semi, sh.column_rows(x)), sh.group)


def dist_tr_spmm(sh: VBCShard, X: torch.Tensor) -> torch.Tensor:
    """``Y = A.T @ X`` (``[n, k]`` on every rank) for a whole ``X [m, k]``."""
    if sh.kernels_take(X):
        Y = tr_spmm(sh.spmm_fmt, X)
    else:
        Y = semiring.tr_spmm(sh.semi, X)
    return comm.gather_y(Y, sh.widths, sh.group)


def dist_spmm(sh: VBCShard, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` (``[m, k]`` on every rank) for a whole ``X [n, k]``."""
    return comm.all_reduce(semiring.spmm(sh.semi, sh.column_rows(X)), sh.group)
