"""Scatter-tier TrSpMV: ``y = alpha * A.T @ x (+ beta * y)`` on a CSC.

Port of ``vbcs_tpu/ops/pallas_scatter.py`` (``pack_scatter``,
``tr_spmv_scatter``; Pallas kernel ``_scatter_kernel``), the operator's
route for unstructured packs whose stripes are about one column wide.
The TPU kernel spread each column over the lanes of an (8, Np) slot
buffer, gathered ``x[row]`` through a radix router, summed 8 sublanes,
ran a segmented lane scan and permuted the column totals out, with
columns past 64 entries spilled to a COO side list: all because Mosaic
cannot gather.  What it computes is a CSC SpMV, so the port packs a CSC
(``ScatterDevice``) and has no slot budget, no spill and no router.  On
a CUDA tensor :func:`tr_spmv_scatter` launches ``csrc/scatter.cu`` over
the pack's tiles of whole columns (``ScatterDevice.tiles``); on a CPU
tensor it runs the plain TrSpMV (``tr_spmv_scatter_plain``, the stripe
kernel's ``tr_spmv_plain``).

Alpha/beta follow the stripe kernel's wrapper (``ops/trspmv.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.device import ScatterDevice
from . import _lib
from .trspmv import _run_tr_spmv, tr_spmv_plain

__all__ = ["MAX_MEAN_WIDTH", "column_entries", "pack_scatter", "scatter_admits",
           "tr_spmv_scatter", "tr_spmv_scatter_plain"]

# The route's one threshold: packs whose mean stripe width is below it
# take the scatter kernel, the rest the stripe kernel.  The JAX package's
# 2.0, exclusive here: on an H100 the scatter kernel is the faster of the
# two on packs of mean width 1.02, 1.17 and 1.994 and the slower (by
# 2-5%) on a pack of uniform width 2 and beyond (GUARD data, PERF.md).
MAX_MEAN_WIDTH = 2.0


def column_entries(B):
    """Flatten a VBC1D into per-column (row, val) entry lists, explicit
    fill kept: (col, j_within_col, row, value index) arrays, j unbounded
    (bitwise the JAX package's ``_column_entries``)."""
    spl = B.Phi.spl.astype(np.int64)
    pos = B.pos.astype(np.int64)
    ofs = B.ofs.astype(np.int64)
    stripe_w = (spl[1:] - spl[:-1]).astype(np.int64)
    nb = (pos[1:] - pos[:-1]).astype(np.int64)
    # entry (stripe l, block b, wi) -> column spl[l]+wi, row idx[pos[l]+b],
    # val[ofs[l] + b*w + wi]; enumerate blocks once, then per-width fan out
    tot = int((nb * stripe_w).sum())
    cols = np.empty(tot, np.int64)
    js = np.empty(tot, np.int64)
    rows = np.empty(tot, np.int64)
    vidx = np.empty(tot, np.int64)
    off = 0
    for w in np.unique(stripe_w):
        st = np.flatnonzero(stripe_w == w)
        nb_w = nb[st]
        nblk = int(nb_w.sum())
        if nblk == 0:
            continue
        e_str = np.repeat(np.arange(st.size), nb_w)
        e_blk = np.arange(nblk) - np.repeat(np.cumsum(nb_w) - nb_w, nb_w)
        gblk = pos[st][e_str] + e_blk
        vbase = ofs[st][e_str] + e_blk * w
        for wi in range(int(w)):
            sl = slice(off, off + nblk)
            cols[sl] = spl[st][e_str] + wi
            js[sl] = e_blk
            rows[sl] = B.idx[gblk]
            vidx[sl] = vbase + wi
            off += nblk
    return cols[:off], js[:off], rows[:off], vidx[:off]


def scatter_admits(B) -> bool:
    """The scatter route's guard: a pack with stripes whose mean width is
    below :data:`MAX_MEAN_WIDTH` (blocking found little to merge)."""
    widths = np.diff(np.asarray(B.Phi.spl, dtype=np.int64))
    return widths.size > 0 and float(widths.mean()) < MAX_MEAN_WIDTH


def pack_scatter(B, device) -> ScatterDevice | None:
    """VBC1D -> the scatter format on ``device``; None when the guard
    (:func:`scatter_admits`) refuses the pack."""
    if not scatter_admits(B):
        return None
    return ScatterDevice.from_host(B, device)


# the plain version: ``index_add_`` of ``val * x[row]`` over the column
# arrays (:attr:`ScatterDevice.value_coords`), as for every TrSpMV format
tr_spmv_scatter_plain = tr_spmv_plain


def tr_spmv_scatter(fmt: ScatterDevice, x: torch.Tensor, alpha=None,
                    beta=None, y=None) -> torch.Tensor:
    """``alpha * A.T @ x (+ beta * y)`` in natural order, shape ``[n]``.

    CUDA tensors run the entry-tiled kernel (or raise); CPU tensors run
    :func:`tr_spmv_plain`.  The kernel's arrival counts live in the
    format (``fmt.tiles.scratch``): calls on one format run in stream
    order, not on two streams at once."""

    def launch(*tail):
        t = fmt.tiles
        _lib.launch(tr_spmv_scatter, "vbcs_tr_spmv_scatter", fmt.device, t.n_tiles,
                    t.empty.numel(), t.tiles.data_ptr(), t.lanes.data_ptr(),
                    fmt.row.data_ptr(), fmt.val.data_ptr(), _lib.ptr(t.out),
                    _lib.ptr(t.empty), t.scratch.data_ptr(), x.data_ptr(), *tail)

    return _run_tr_spmv(tr_spmv_scatter, tr_spmv_plain, fmt, x, alpha, beta, y, launch)


tr_spmv_scatter.launches = 0
