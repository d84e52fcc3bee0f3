"""VBCOperator — the user-facing sparse operator.

Port of ``vbcs_tpu/operator.py`` (1-D operator, f32).  ``from_csc``
plans and packs ``A`` (and ``A.T``) on the host exactly as the JAX
operator does — the min-memory DP, ``pack_1dvbc`` and the auto-RCM
decision — then copies the packs to an explicit torch ``device``:

* ``tr_mul``: ``y = alpha * A.T @ x + beta * y`` through the stripe
  kernel (``ops/trspmv.py``), alpha/beta fused into its store;
* ``mul``: ``y = alpha * A @ x + beta * y``, the same kernel on the
  column-striped ``A.T`` (scatter-free);
* ``tr_mul_mat``/``mul_mat``: ``Y = A.T @ X`` and ``Y = A @ X`` for a
  dense RHS ``X [rows, k]``, through the stripe SpMM kernel
  (``ops/spmm.py``) on the same two packs;
* auto-RCM operators hold ``A[perm][:, perm]`` and gather x in and y
  out at the boundaries (``ops/gather.py``; ``index_select`` for the
  rows of X and Y, as the JAX operator leaves those to XLA).

Both kernels write natural order, so nothing follows them on a natural
operator.  f64, bool and int32 semirings, ``tr_mul_chain`` and
``VBC2DOperator`` wait (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import default_1d_partitioner
from .formats.csc import CSC
from .formats.device import VBC1DDevice
from .formats.vbc1d import VBC1D, pack_1dvbc
from .ops.gather import gather
from .ops.spmm import _check_mat, tr_spmm
from .ops.trspmv import _check_vec, tr_spmv
from .plan.alternating import pack_stripe
from .plan.reorder import rcm_symmetric, window_badness

__all__ = ["VBCOperator", "VBC2DOperator", "route_tr_spmv"]

_WAITS = "is not ported yet; see ROADMAP.md, queue 1"


def route_tr_spmv(B, device):
    """The per-call TrSpMV kernel :meth:`VBCOperator.tr_mul` runs for a
    packed f32 format ``B`` — ``(name, fmt, call)`` with
    ``call(fmt, x) -> y`` — for harnesses that must time the shipped
    path.  The port has one route: the stripe kernel takes every plan."""
    return "stripe", VBC1DDevice.from_host(B, device), tr_spmv


def _axpby(out, alpha, beta, y):
    """alpha*out + beta*y with the defaults (None) doing nothing."""
    if alpha is not None:
        out = out * alpha
    if y is not None and beta is not None:
        out = out + beta * y
    return out


def _as_csc(A) -> CSC:
    return A if isinstance(A, CSC) else CSC.from_scipy(A)


@dataclasses.dataclass(frozen=True)
class VBCOperator:
    """Sparse matrix operator in 1D-VBC form on one torch device."""

    m: int
    n: int
    host_tr: VBC1D | None  # column-striped A (for A.T @ x)
    host_fw: VBC1D | None  # column-striped A.T (for A @ x)
    device: torch.device
    dev_tr: VBC1DDevice | None
    dev_fw: VBC1DDevice | None
    row_perm: np.ndarray | None = None  # symmetric relabeling (auto-RCM)
    perm_t: torch.Tensor | None = None  # int32 perm on device
    inv_t: torch.Tensor | None = None  # int32 inverse perm on device

    # ---- construction ----------------------------------------------------

    @staticmethod
    def from_csc(
        A,
        W: int = 8,
        method=None,
        method_forward=None,
        directions: str = "both",
        reorder: str = "auto",
        *,
        device,
    ) -> "VBCOperator":
        """Plan + pack ``A`` (and/or ``A.T``) and copy the packs to ``device``.

        ``directions``: "both" | "transposed" (A.T@x only) | "forward".
        ``method`` plans the columns of A; ``method_forward`` the columns
        of A.T (defaults to ``method``).

        ``reorder``: "auto" applies a *symmetric* RCM relabeling when the
        JAX package's locality estimate (``window_badness``) says it
        helps; "never"/"always" force it off/on.  The operator carries the
        permutation and applies it at the call boundaries.
        """
        if directions not in ("both", "transposed", "forward"):
            raise ValueError(f"unknown directions {directions!r}")
        if reorder not in ("auto", "always", "never"):
            raise ValueError(f"unknown reorder {reorder!r}")
        A = _as_csc(A)
        if A.val.dtype != np.float32:
            raise NotImplementedError(
                f"the port runs float32 matrices only, got {A.val.dtype}; "
                f"f64, bool and int32 semirings {_WAITS} item 3")
        method = method or default_1d_partitioner(W, A.val.dtype.itemsize)
        method_forward = method_forward or method

        row_perm = None
        probe_pack = None  # reused as host_tr (same method/W as the probe)
        if reorder in ("auto", "always") and A.m == A.n and A.m > 1024:
            probe_pack = pack_1dvbc(A, pack_stripe(A, method), W)
            bad = window_badness(probe_pack)
            if reorder == "always" or bad > 0.05:
                Ap, perm = rcm_symmetric(A)
                probe_p = pack_1dvbc(Ap, pack_stripe(Ap, method), W)
                if reorder == "always" or window_badness(probe_p) < bad:
                    A, row_perm = Ap, perm
                    probe_pack = probe_p

        host_tr = host_fw = None
        if directions in ("both", "transposed"):
            if probe_pack is not None:
                host_tr = probe_pack
            else:
                host_tr = pack_1dvbc(A, pack_stripe(A, method), W)
        if directions in ("both", "forward"):
            At = A.transpose()
            host_fw = pack_1dvbc(At, pack_stripe(At, method_forward), W)
        return VBCOperator.from_host(host_tr, host_fw, row_perm, device)

    @staticmethod
    def from_host(host_tr, host_fw, row_perm, device) -> "VBCOperator":
        """Operator over existing packs (this port's or the JAX package's
        ``VBC1D``): ``host_tr`` packs A, ``host_fw`` packs A.T, either may
        be None; ``row_perm`` is the symmetric relabeling the packs were
        built under, or None."""
        device = torch.device(device)
        host = host_tr if host_tr is not None else host_fw
        if host is None:
            raise ValueError("need at least one of host_tr and host_fw")
        for h in (host_tr, host_fw):
            if h is not None and np.asarray(h.val).dtype != np.float32:
                raise NotImplementedError(
                    f"the port runs float32 matrices only, got "
                    f"{np.asarray(h.val).dtype}; other semirings {_WAITS} "
                    f"item 3")
        m, n = (host.m, host.n) if host is host_tr else (host.n, host.m)
        if host_tr is not None and host_fw is not None and (
                host_fw.m, host_fw.n) != (n, m):
            raise ValueError("host_fw must pack the transpose of host_tr")
        perm_t = inv_t = None
        if row_perm is not None:
            row_perm = np.asarray(row_perm, dtype=np.int64)
            if m != n or not np.array_equal(np.sort(row_perm), np.arange(m)):
                raise ValueError("row_perm must be a permutation of range(m) "
                                 "of a square operator")
            inv = np.empty_like(row_perm)
            inv[row_perm] = np.arange(m)
            perm_t = torch.from_numpy(row_perm.astype(np.int32)).to(device)
            inv_t = torch.from_numpy(inv.astype(np.int32)).to(device)
        return VBCOperator(
            m=int(m), n=int(n), host_tr=host_tr, host_fw=host_fw,
            device=device,
            dev_tr=None if host_tr is None else VBC1DDevice.from_host(host_tr, device),
            dev_fw=None if host_fw is None else VBC1DDevice.from_host(host_fw, device),
            row_perm=row_perm, perm_t=perm_t, inv_t=inv_t,
        )

    @property
    def shape(self):
        return (self.m, self.n)

    def memory_bytes(self) -> int:
        total = 0
        if self.host_tr is not None:
            total += self.host_tr.memory_bytes()
        if self.host_fw is not None:
            total += self.host_fw.memory_bytes()
        return total

    # ---- compute ---------------------------------------------------------

    def _apply(self, fmt, x, alpha, beta, y):
        if self.row_perm is None:
            return tr_spmv(fmt, x, alpha, beta, y)  # alpha/beta fused
        # the gather reads x[perm] unchecked on the card, and y skips the
        # kernel: check both as tr_spmv would
        _check_vec("x", x, fmt.m, fmt.device)
        if y is not None and beta is not None:
            _check_vec("y", y, fmt.n, fmt.device)
        out = tr_spmv(fmt, gather(x, self.perm_t), alpha)  # alpha fused
        return _axpby(gather(out, self.inv_t), None, beta, y)

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on the operator's device
        (reference ``mul!(y, A', x, alpha, beta)``, with ``alpha``
        applied)."""
        if self.dev_tr is None:
            raise ValueError("operator packed without the transposed direction")
        return self._apply(self.dev_tr, x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on the operator's device
        (scatter-free: the gather kernel on the A.T pack)."""
        if self.dev_fw is None:
            raise ValueError("operator packed without the forward direction")
        return self._apply(self.dev_fw, x, alpha, beta, y)

    def tr_mul_chain(self, x, n_iters: int, alpha=None):
        raise NotImplementedError(f"tr_mul_chain {_WAITS} item 6")

    def _apply_mat(self, fmt, X):
        if self.row_perm is None:
            return tr_spmm(fmt, X)
        _check_mat("X", X, fmt.m, fmt.device)  # before the unchecked gather
        out = tr_spmm(fmt, X.index_select(0, self.perm_t))
        return out.index_select(0, self.inv_t)

    def tr_mul_mat(self, X):
        """Y = A.T @ X for a dense RHS ``X [m, k]`` on the operator's
        device (SpMM; reference ``mul!(Y, A', X)``)."""
        if self.dev_tr is None:
            raise ValueError("operator packed without the transposed direction")
        return self._apply_mat(self.dev_tr, X)

    def mul_mat(self, X):
        """Y = A @ X for a dense RHS ``X [n, k]`` on the operator's device
        (scatter-free: the SpMM kernel on the A.T pack)."""
        if self.dev_fw is None:
            raise ValueError("operator packed without the forward direction")
        return self._apply_mat(self.dev_fw, X)

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)


class VBC2DOperator:
    """The 2-D VBC operator (``vbcs_tpu.operator.VBC2DOperator``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"VBC2DOperator {_WAITS} item 8")

    @staticmethod
    def from_csc(*args, **kwargs):
        raise NotImplementedError(f"VBC2DOperator {_WAITS} item 8")
