"""Row and column reorderings for x locality, and the JAX package's
estimate that decides its auto-RCM.

Port of ``vbcs_tpu/plan/reorder.py`` (NumPy/SciPy; bitwise the same
permutations and CSC arrays): the row reorderings :func:`rcm_rows`
(reverse Cuthill-McKee on the symmetrized graph, or on ``A @ A.T`` for a
rectangle) and :func:`profile_rows` (rows by the mean column of their
nonzeros, empty rows last), both returning ``(A[perm, :], perm)``; for
``y = A.T @ x`` only ``x -> x[perm]`` changes.  Then the symmetric
relabeling :func:`rcm_symmetric`, which the port's auto-RCM applies, and
:func:`window_badness`, the JAX operator's estimate of the TPU stream
kernel's x-gather through aligned 1024-element windows.  The port's
``VBCOperator.from_csc`` does not read that estimate: on the card every
call but the chain runs a relabeled pack's natural view, so it relabels
only where RCM shrinks the packs it holds (``operator.py``).
"""

from __future__ import annotations

import numpy as np

from ..formats.csc import CSC
from ..utils import trace

__all__ = ["apply_row_perm", "rcm_rows", "profile_rows", "rcm_symmetric",
           "window_badness"]


def apply_row_perm(A: CSC, perm: np.ndarray) -> CSC:
    """``A[perm, :]`` as CSC (row ``perm[k]`` becomes row ``k``)."""
    import scipy.sparse as sp

    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    S = A.to_scipy().tocoo()
    return CSC.from_scipy(
        sp.coo_matrix((S.data, (inv[S.row], S.col)), shape=(A.m, A.n)))


def rcm_rows(A: CSC):
    """Reverse Cuthill-McKee row order: on ``A + A.T`` for a square matrix,
    on the row graph ``A @ A.T`` otherwise.  Returns ``(A[perm, :], perm)``."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = A.to_scipy()
    G = (S + S.T).tocsr() if A.m == A.n else (S @ S.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
    return apply_row_perm(A, perm), perm


def profile_rows(A: CSC):
    """Rows by the mean column of their nonzeros (stable; empty rows last).
    Returns ``(A[perm, :], perm)``."""
    S = A.to_scipy().tocsr()
    per_row = np.diff(S.indptr)
    # exact integer sums, as the JAX package's np.add.reduceat, which
    # raises when the last row is empty
    sums = np.bincount(np.repeat(np.arange(A.m), per_row),
                       weights=S.indices.astype(np.float64), minlength=A.m)
    mean = sums / np.maximum(1, per_row)
    mean[per_row == 0] = np.inf
    perm = np.argsort(mean, kind="stable")
    return apply_row_perm(A, perm), perm


def rcm_symmetric(A: CSC):
    """Symmetric RCM: ``A_perm = A[perm][:, perm]`` (square only).

    A symmetric relabeling maps permuted space to permuted space, so
    chained products pay the boundary permutation once, not per
    multiply."""
    with trace.span("plan.rcm"):
        if A.m != A.n:
            raise ValueError("symmetric reorder needs a square matrix")
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        S = A.to_scipy().tocsr()
        sym = (S + S.T).tocsr()
        perm = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
        Sp = S[perm][:, perm].tocsc()
        return CSC.from_scipy(Sp), perm


def window_badness(B, ng: int = 1024, max_w: int = 6) -> float:
    """Fraction of stream vregs whose x-gather would exceed ``max_w``
    aligned 1024-element windows — the JAX package's pack-free estimate
    of how much of the matrix would fall off its Pallas stream path.

    Approximates that packer's chunking: stripes in order, ~128 block
    groups per vreg, window = distinct ``row >> 10`` tiles."""
    with trace.span("plan.badness"):
        nb = (B.pos[1:] - B.pos[:-1]).astype(np.int64)
        ngr = np.maximum(1, -(-nb // 8))
        grp_stripe = np.repeat(np.arange(nb.size), ngr)
        vreg_of_grp = np.arange(grp_stripe.size) // 128
        # tiles of each stripe's row range (cheap proxy: min/max row)
        lo = np.zeros(nb.size, dtype=np.int64)
        hi = np.zeros(nb.size, dtype=np.int64)
        for l in range(nb.size):
            sl = B.idx[B.pos[l]:B.pos[l + 1]]
            if sl.size:
                lo[l], hi[l] = sl.min() >> 10, sl.max() >> 10
        nvreg = int(vreg_of_grp.max()) + 1 if vreg_of_grp.size else 1
        vlo = np.full(nvreg, np.iinfo(np.int64).max)
        vhi = np.zeros(nvreg, dtype=np.int64)
        np.minimum.at(vlo, vreg_of_grp, lo[grp_stripe])
        np.maximum.at(vhi, vreg_of_grp, hi[grp_stripe])
        spans = np.maximum(vhi - np.minimum(vlo, vhi) + 1, 1)
        return float((spans > max_w).mean())
