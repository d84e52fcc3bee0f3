"""2-D Variable Block Column (VBC) sparse format — host container.

Port of ``vbcs_tpu/formats/vbc2d.py`` (NumPy; bitwise the same arrays).
It is the reference type ``SparseMatrixVBC{U,W,Tv,Ti}``
(``src/SparseMatrixVBCs.jl:57-84``) with its converter
(``src/constructors_VBC.jl:15-133``): on top of the 1-D column stripes,
rows are grouped into ``K`` variable-height blocks (height ``u_k <= U``)
by a row partition ``Pi``; the nonzero blocks of column stripe ``l`` are
the distinct *row-blocks* ``k`` touched by its columns, each stored as a
dense ``u_k x w_l`` tile in row-major order with explicit zero fill.

``idx[Q]`` holds the row-block id ``k`` (ascending within a stripe);
``ofs[l+1] - ofs[l] = sum_Q u_{idx[Q]} * w_l``.  The device copy of these
arrays is :class:`~vbcs_tpu_torch.formats.device.VBC2DDevice`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.dtypes import acc_dtype
from .csc import CSC
from .partition import SplitPartition
from .vbc1d import VBC1D

__all__ = ["VBC2D", "pack_vbc2d"]


@dataclasses.dataclass(frozen=True)
class VBC2D:
    m: int
    n: int
    U: int  # max row-block height
    W: int  # max stripe width
    Pi: SplitPartition  # row partition, K blocks
    Phi: SplitPartition  # column partition, L stripes
    pos: np.ndarray  # [L + 1] block pointers into idx
    idx: np.ndarray  # [num_blocks] row-block ids
    ofs: np.ndarray  # [L + 1] value offsets per stripe
    val: np.ndarray  # [total_vals] tile values, row-major u x w per block

    def __post_init__(self):
        if self.U <= 0 or self.W <= 0:
            raise ValueError("U and W must be > 0")
        if self.Pi.max_width() > self.U:
            raise ValueError("row-block height exceeds U")
        if self.Phi.max_width() > self.W:
            raise ValueError("stripe width exceeds W")

    @property
    def K(self) -> int:
        return len(self.Pi)

    @property
    def L(self) -> int:
        return len(self.Phi)

    @property
    def num_blocks(self) -> int:
        return int(self.idx.size)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.val.dtype

    def memory_bytes(self) -> int:
        """Pi + Phi + pos + idx + ofs + val (reference bin/test_table.jl:119)."""
        return (
            self.Pi.spl.nbytes
            + self.Phi.spl.nbytes
            + self.pos.nbytes
            + self.idx.nbytes
            + self.ofs.nbytes
            + self.val.nbytes
        )

    # ---- oracle kernels ---------------------------------------------------

    def _stripe_blocks(self, l: int):
        """Yield (k, i0, u, tile[u, w]) for each block of stripe ``l``."""
        j0, j1 = self.Phi.chunk(l)
        w = j1 - j0
        q = int(self.ofs[l])
        for Q in range(int(self.pos[l]), int(self.pos[l + 1])):
            k = int(self.idx[Q])
            i0, i1 = self.Pi.chunk(k)
            u = i1 - i0
            tile = self.val[q : q + u * w].reshape(u, w)
            q += u * w
            yield k, i0, u, tile

    def mul(self, x: np.ndarray, alpha=1, beta=0, y=None) -> np.ndarray:
        """y = alpha * (A @ x) + beta * y (reference src/multiply_VBC.jl:3-87)."""
        out_dtype = acc_dtype(self.val.dtype, np.asarray(x).dtype)
        if y is None:
            y = np.zeros(self.m, dtype=out_dtype)
        else:
            y = beta * y.astype(out_dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            xs = x[j0:j1].astype(out_dtype)
            for _, i0, u, tile in self._stripe_blocks(l):
                y[i0 : i0 + u] += alpha * (tile.astype(out_dtype) @ xs)
        return y

    def tr_mul(self, x: np.ndarray, alpha=1, beta=0, y=None) -> np.ndarray:
        """y = alpha * (A.T @ x) + beta * y (reference src/multiply_VBC.jl:104-189)."""
        out_dtype = acc_dtype(self.val.dtype, np.asarray(x).dtype)
        if y is None:
            y = np.zeros(self.n, dtype=out_dtype)
        else:
            y = beta * y.astype(out_dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            acc = np.zeros(j1 - j0, dtype=out_dtype)
            for _, i0, u, tile in self._stripe_blocks(l):
                acc += x[i0 : i0 + u].astype(out_dtype) @ tile.astype(out_dtype)
            y[j0:j1] += alpha * acc
        return y

    def to_dense(self) -> np.ndarray:
        D = np.zeros((self.m, self.n), dtype=self.val.dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            for _, i0, u, tile in self._stripe_blocks(l):
                D[i0 : i0 + u, j0:j1] = tile
        return D

    def to_1d_view(self) -> VBC1D:
        """Zero-copy 1D-VBC view: each u x w block expands to u row
        slices.  The 2-D row-major tile layout coincides exactly with
        the 1-D per-row layout, so ``val``/``ofs`` are shared; only the
        block list (``pos``/``idx``) is expanded."""
        heights = self.Pi.widths()
        widths = self.Phi.widths()
        # expanded rows per stripe = stripe value count / stripe width
        sizes = np.diff(self.ofs)
        with np.errstate(divide="ignore", invalid="ignore"):
            rows_per_stripe = np.where(widths > 0, sizes // np.maximum(widths, 1), 0)
        pos1 = np.zeros(self.L + 1, dtype=np.int64)
        np.cumsum(rows_per_stripe, out=pos1[1:])
        # expand block row-starts into consecutive row ids
        u_of_block = heights[self.idx]
        starts = self.Pi.spl[self.idx]
        total = int(u_of_block.sum())
        idx1 = np.zeros(total, dtype=np.int64)
        if total:
            base = np.zeros(self.num_blocks + 1, dtype=np.int64)
            np.cumsum(u_of_block, out=base[1:])
            off = np.arange(total) - np.repeat(base[:-1], u_of_block)
            idx1 = np.repeat(starts, u_of_block) + off
        return VBC1D(
            m=self.m,
            n=self.n,
            W=self.W,
            Phi=self.Phi,
            pos=pos1,
            idx=idx1,
            ofs=self.ofs,
            val=self.val,
        )


def pack_vbc2d(
    A: CSC,
    Pi: SplitPartition,
    Phi: SplitPartition,
    U: int | None = None,
    W: int | None = None,
) -> VBC2D:
    """Pack CSC into 2-D VBC given row and column partitions.

    Vectorized equivalent of the reference two-pass converter
    (``src/constructors_VBC.jl:15-133``): pass 1's distinct-row-block count
    and pass 2's cursor merge become a sort/unique over (stripe, row-block)
    keys plus a scatter of nonzeros into their tile slots.
    """
    m, n = A.m, A.n
    if Pi.n != m:
        raise ValueError("row partition does not cover the rows of A")
    if Phi.n != n:
        raise ValueError("column partition does not cover the columns of A")
    K, L = len(Pi), len(Phi)
    heights = Pi.widths()
    widths = Phi.widths()
    if U is None:
        U = max(1, int(heights.max(initial=1)))
    if W is None:
        W = max(1, int(widths.max(initial=1)))

    nnz = A.nnz
    col_of_nz = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.pos))
    stripe_of_nz = np.searchsorted(Phi.spl, col_of_nz, side="right") - 1
    rb_of_nz = np.searchsorted(Pi.spl, A.idx, side="right") - 1

    key = stripe_of_nz * np.int64(max(K, 1)) + rb_of_nz
    uniq, inverse = np.unique(key, return_inverse=True)
    block_stripe = (uniq // max(K, 1)).astype(np.int64)
    block_k = (uniq % max(K, 1)).astype(np.int64)

    blocks_per_stripe = np.bincount(block_stripe, minlength=L).astype(np.int64)
    pos = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(blocks_per_stripe, out=pos[1:])

    block_sizes = heights[block_k] * widths[block_stripe]
    base = np.zeros(block_k.size + 1, dtype=np.int64)
    np.cumsum(block_sizes, out=base[1:])

    stripe_sizes = np.bincount(
        block_stripe, weights=block_sizes.astype(np.float64), minlength=L
    ).astype(np.int64)
    ofs = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(stripe_sizes, out=ofs[1:])

    val = np.zeros(int(base[-1]), dtype=A.val.dtype)
    if nnz:
        b = inverse
        vpos = (
            base[b]
            + (A.idx - Pi.spl[block_k[b]]) * widths[block_stripe[b]]
            + (col_of_nz - Phi.spl[block_stripe[b]])
        )
        val[vpos] = A.val

    return VBC2D(
        m=m,
        n=n,
        U=int(U),
        W=int(W),
        Pi=Pi,
        Phi=Phi,
        pos=pos,
        idx=block_k,
        ofs=ofs,
        val=val,
    )
