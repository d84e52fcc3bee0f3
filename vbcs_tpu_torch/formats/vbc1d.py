"""1-D Variable Block Column (1D-VBC) sparse format — host container.

Port of ``vbcs_tpu/formats/vbc1d.py`` (NumPy + the shared C++ packer;
bitwise the same arrays).  It is the reference type
``SparseMatrix1DVBC{W,Tv,Ti}`` (``src/SparseMatrixVBCs.jl:31-55``) with
its CSC converter (``src/constructors_1DVBC.jl:9-92``):

* columns are grouped into ``L`` variable-width stripes by a
  :class:`~vbcs_tpu_torch.formats.partition.SplitPartition` ``Phi``
  (width of stripe ``l`` is ``w_l = spl[l+1] - spl[l] <= W``);
* the nonzero *blocks* of stripe ``l`` are the distinct rows appearing in
  any of its columns; block ``Q`` stores a dense 1 x w_l row slice with
  explicit zero fill for absent entries;
* ``pos[l]:pos[l+1]`` indexes ``idx`` (block row ids, ascending within a
  stripe), ``ofs[l]`` is the start of stripe ``l``'s values in ``val``
  (blocks are w_l contiguous values each, in block order).

The device copy of these arrays is
:class:`~vbcs_tpu_torch.formats.device.VBC1DDevice`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..native import pack_1dvbc_native
from ..utils import trace
from ..utils.dtypes import acc_dtype
from .csc import CSC
from .partition import SplitPartition

__all__ = ["VBC1D", "pack_1dvbc"]


@dataclasses.dataclass(frozen=True)
class VBC1D:
    m: int
    n: int
    W: int  # maximum stripe width (format invariant: all widths <= W)
    Phi: SplitPartition  # column partition, L stripes
    pos: np.ndarray  # [L + 1] block pointers into idx
    idx: np.ndarray  # [num_blocks] block row indices
    ofs: np.ndarray  # [L + 1] value offsets per stripe
    val: np.ndarray  # [total_vals] block values (w-contiguous per block)

    def __post_init__(self):
        if self.W <= 0:
            raise ValueError("W must be > 0")
        if self.m < 0 or self.n < 0:
            raise ValueError("m and n must be >= 0")
        if self.Phi.max_width() > self.W:
            raise ValueError("stripe width exceeds W")

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
        """Format footprint: Phi + pos + idx + ofs + val
        (reference bin/test_table.jl:77)."""
        return (
            self.Phi.spl.nbytes
            + self.pos.nbytes
            + self.idx.nbytes
            + self.ofs.nbytes
            + self.val.nbytes
        )

    # ---- oracle kernels (NumPy; the in-repo correctness reference) --------

    def stripe_vals(self, l: int) -> np.ndarray:
        """Values of stripe ``l`` as a [nblocks_l, w_l] dense array."""
        j0, j1 = self.Phi.chunk(l)
        w = j1 - j0
        nb = int(self.pos[l + 1] - self.pos[l])
        return self.val[self.ofs[l] : self.ofs[l] + nb * w].reshape(nb, w)

    def mul(self, x: np.ndarray, alpha=1, beta=0, y=None) -> np.ndarray:
        """y = alpha * (A @ x) + beta * y — forward (scatter) SpMV oracle
        (reference ``src/multiply_1DVBC.jl:13-83``, with ``alpha`` applied;
        the reference converts but ignores it)."""
        out_dtype = acc_dtype(self.val.dtype, np.asarray(x).dtype)
        if y is None:
            y = np.zeros(self.m, dtype=out_dtype)
        else:
            y = beta * y.astype(out_dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            vals = self.stripe_vals(l).astype(out_dtype)
            rows = self.idx[self.pos[l] : self.pos[l + 1]]
            contrib = vals @ x[j0:j1].astype(out_dtype)
            np.add.at(y, rows, alpha * contrib)
        return y

    def tr_mul(self, x: np.ndarray, alpha=1, beta=0, y=None) -> np.ndarray:
        """y = alpha * (A.T @ x) + beta * y — transposed (gather) SpMV
        oracle; the paper's hot op (reference ``src/multiply_1DVBC.jl:90-180``).
        """
        out_dtype = acc_dtype(self.val.dtype, np.asarray(x).dtype)
        if y is None:
            y = np.zeros(self.n, dtype=out_dtype)
        else:
            y = beta * y.astype(out_dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            vals = self.stripe_vals(l).astype(out_dtype)
            rows = self.idx[self.pos[l] : self.pos[l + 1]]
            y[j0:j1] += alpha * (x[rows].astype(out_dtype) @ vals)
        return y

    def to_dense(self) -> np.ndarray:
        D = np.zeros((self.m, self.n), dtype=self.val.dtype)
        for l in range(self.L):
            j0, j1 = self.Phi.chunk(l)
            rows = self.idx[self.pos[l] : self.pos[l + 1]]
            D[rows, j0:j1] = self.stripe_vals(l)
        return D


def pack_1dvbc(A: CSC, Phi: SplitPartition, W: int | None = None) -> VBC1D:
    """Pack a CSC matrix into 1D-VBC given a column partition.

    Vectorized equivalent of the reference two-pass converter
    (``src/constructors_1DVBC.jl:9-92``): identifies the distinct
    (stripe, row) blocks via a sort/unique and fills a dense w-slice per
    block with explicit zeros.
    """
    with trace.span("plan.pack"):
        m, n = A.m, A.n
        spl = Phi.spl
        L = len(Phi)
        widths = Phi.widths()
        if W is None:
            W = max(1, int(widths.max(initial=1)))
        if int(widths.max(initial=0)) > W:
            raise ValueError(f"partition width {int(widths.max())} exceeds W={W}")
        if Phi.n != n:
            raise ValueError("partition does not cover the columns of A")

        # C++ fast path (exact same layout).  float64 staging is value-exact
        # for f32/f64/ints<2^53/bool.
        if A.val.dtype.kind in "fb" or (
            A.val.dtype.kind in "iu" and A.val.dtype.itemsize <= 4
        ):
            packed = pack_1dvbc_native(m, n, A.pos, A.idx, A.val, spl)
            if packed is not None:
                bpos, bidx, bofs, bval = packed
                return VBC1D(
                    m=m,
                    n=n,
                    W=int(W),
                    Phi=Phi,
                    pos=bpos,
                    idx=bidx,
                    ofs=bofs,
                    val=bval.astype(A.val.dtype),
                )

        nnz = A.nnz
        col_of_nz = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.pos))
        stripe_of_nz = np.searchsorted(spl, col_of_nz, side="right") - 1

        # Distinct (stripe, row) pairs, ordered by stripe then row — the block
        # list.  ``inverse`` maps each nonzero to its block.
        key = stripe_of_nz * np.int64(max(m, 1)) + A.idx
        uniq, inverse = np.unique(key, return_inverse=True)
        block_stripe = uniq // max(m, 1)
        block_row = uniq % max(m, 1)

        blocks_per_stripe = np.bincount(block_stripe, minlength=L).astype(np.int64)
        pos = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(blocks_per_stripe, out=pos[1:])

        ofs = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(blocks_per_stripe * widths, out=ofs[1:])

        val = np.zeros(int(ofs[-1]), dtype=A.val.dtype)
        if nnz:
            b = inverse  # block id per nonzero
            l_of_nz = stripe_of_nz
            # value position: stripe base + block slot * width + column offset
            vpos = (
                ofs[l_of_nz]
                + (b - pos[l_of_nz]) * widths[l_of_nz]
                + (col_of_nz - spl[l_of_nz])
            )
            val[vpos] = A.val

        return VBC1D(
            m=m,
            n=n,
            W=int(W),
            Phi=Phi,
            pos=pos,
            idx=block_row.astype(np.int64),
            ofs=ofs,
            val=val,
        )
