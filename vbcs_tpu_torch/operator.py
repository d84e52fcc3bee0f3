"""VBCOperator and VBC2DOperator — the user-facing sparse operators.

Port of ``vbcs_tpu/operator.py`` (f32).  ``from_csc``
plans and packs ``A`` (and ``A.T``) on the host exactly as the JAX
operator does — the min-memory DP, ``pack_1dvbc`` and the auto-RCM
decision — then copies the packs to an explicit torch ``device``:

* ``tr_mul``: ``y = alpha * A.T @ x + beta * y`` through the kernel
  :func:`route_tr_spmv` picks for the pack — the stripe kernel
  (``ops/trspmv.py``) or, on unstructured packs, the column-parallel
  scatter kernel (``ops/scatter.py``) — alpha/beta fused into its store;
* ``mul``: ``y = alpha * A @ x + beta * y``, the same route on the
  column-striped ``A.T`` (scatter-free);
* ``tr_mul_chain``: ``y = (alpha * A.T)^k @ x`` for a square operator, one
  launch of the persistent chain kernel (``ops/chain.py``);
* ``tr_mul_mat``/``mul_mat``: ``Y = A.T @ X`` and ``Y = A @ X`` for a
  dense RHS ``X [rows, k]``, through the stripe SpMM kernel
  (``ops/spmm.py``) on the same two packs;
* auto-RCM operators hold ``A[perm][:, perm]`` and run ``tr_mul``,
  ``mul``, ``tr_mul_mat`` and ``mul_mat`` on its natural views
  (``natural_view``: rows ``perm[idx]``, output column ``j`` at
  ``perm[j]``), one launch a call with no gather; ``tr_mul_chain`` runs
  the relabeled pack between two gathers (``ops/gather.py``), where its
  shared-memory x window relies on the RCM's locality.

``VBC2DOperator.from_csc`` plans and packs the 2-D format (the
alternating planner and ``pack_vbc2d``) of ``A`` and of ``A.T`` with U
and W swapped; ``tr_mul``/``mul`` run the tile kernel
(``ops/trspmv2d.py``) on those packs, ``tr_mul_mat``/``mul_mat`` the
SpMM kernel on their 1-D views, as the JAX operator does.

Every kernel writes natural order, so nothing follows it.  f64, bool and
int32 semirings wait (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .api import default_1d_partitioner, vbc2d
from .formats.csc import CSC
from .formats.device import VBC1DDevice, VBC2DDevice
from .formats.vbc1d import VBC1D, pack_1dvbc
from .ops.chain import tr_spmv_chain
from .ops.gather import gather
from .ops.scatter import pack_scatter, scatter_admits, tr_spmv_scatter
from .ops.spmm import tr_spmm
from .ops.trspmv import _check_vec, tr_spmv
from .ops.trspmv2d import tr_spmv_2d
from .plan.alternating import pack_stripe
from .plan.reorder import rcm_symmetric, window_badness

__all__ = ["VBCOperator", "VBC2DOperator", "route_tr_spmv", "route_tr_spmv_2d"]

_WAITS = "is not ported yet; see ROADMAP.md, queue 1"


def route_tr_spmv(B, device, stripe: VBC1DDevice | None = None,
                  perm: torch.Tensor | None = None):
    """The per-call TrSpMV kernel :meth:`VBCOperator.tr_mul` runs for a
    packed f32 format ``B`` — ``(name, fmt, call)`` with
    ``call(fmt, x, alpha, beta, y) -> y`` — for harnesses that must time
    the shipped path, and the one place the operator's route is decided.

    ``"scatter"`` (the entry-tiled kernel on ``B``'s CSC) when the
    scatter guard admits ``B`` (``ops.scatter.scatter_admits``: mean
    stripe width at most ``MAX_MEAN_WIDTH``), else ``"stripe"``.  The JAX
    package tries its one-shot first and reaches the scatter tier only
    when that pack refuses; the port's stripe kernel refuses nothing, so
    the guard alone decides.  ``stripe`` is ``B`` already on ``device``,
    reused instead of a second copy.  ``perm`` (int32 on ``device``) says
    that ``B`` packs ``A[perm][:, perm]``: the route's format is then the
    natural view of its pack (``natural_view``), whose call reads natural
    x and writes natural y."""
    fmt = pack_scatter(B, device)
    if fmt is not None:
        return ("scatter", fmt if perm is None else fmt.natural_view(perm),
                tr_spmv_scatter)
    if stripe is None:
        stripe = VBC1DDevice.from_host(B, device)
    if perm is not None and stripe.col_out is None:
        stripe = stripe.natural_view(perm)
    return "stripe", stripe, tr_spmv


def route_tr_spmv_2d(B2, device):
    """The per-call TrSpMV kernel :meth:`VBC2DOperator.tr_mul` runs for a
    packed f32 2-D format ``B2`` — ``(name, fmt, call)``.  The port has
    one route: the tile kernel reads each tile's height, so it takes
    uniform and mixed-height stripes alike.  The JAX package's guard
    between its 1-D view and its 2-D kernel (``_v3_view_worthwhile``)
    compares Mosaic exit plans the port does not have."""
    return "tile2d", VBC2DDevice.from_host(B2, device), tr_spmv_2d


def _check_f32(*hosts) -> None:
    for h in hosts:
        if h is not None and np.asarray(h.val).dtype != np.float32:
            raise NotImplementedError(
                f"the port runs float32 matrices only, got "
                f"{np.asarray(h.val).dtype}; other semirings {_WAITS} item 3")


def _as_csc(A) -> CSC:
    return A if isinstance(A, CSC) else CSC.from_scipy(A)


def _shape_of(host_tr, host_fw) -> tuple[int, int]:
    """(m, n) of the operator over the packs of A and of A.T (either may
    be None); refuses non-f32 packs and a pair that do not transpose."""
    host = host_tr if host_tr is not None else host_fw
    if host is None:
        raise ValueError("need at least one of host_tr and host_fw")
    _check_f32(host_tr, host_fw)
    m, n = (host.m, host.n) if host is host_tr else (host.n, host.m)
    if host_tr is not None and host_fw is not None and (
            host_fw.m, host_fw.n) != (n, m):
        raise ValueError("host_fw must pack the transpose of host_tr")
    return int(m), int(n)


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
        _check_f32(A)
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
        m, n = _shape_of(host_tr, host_fw)
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
            m=m, n=n, host_tr=host_tr, host_fw=host_fw,
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

    def _packed(self, which: str) -> VBC1DDevice:
        fmt = self.dev_tr if which == "tr" else self.dev_fw
        if fmt is None:
            name = "transposed" if which == "tr" else "forward"
            raise ValueError(f"operator packed without the {name} direction")
        return fmt

    @functools.cached_property
    def nat_tr(self) -> VBC1DDevice:
        """The A pack in natural order: ``dev_tr``, or on an auto-RCM
        operator its natural view (built on first use)."""
        fmt = self._packed("tr")
        return fmt if self.perm_t is None else fmt.natural_view(self.perm_t)

    @functools.cached_property
    def nat_fw(self) -> VBC1DDevice:
        """The A.T pack in natural order (see :attr:`nat_tr`)."""
        fmt = self._packed("fw")
        return fmt if self.perm_t is None else fmt.natural_view(self.perm_t)

    def _route(self, which: str):
        host = self.host_tr if which == "tr" else self.host_fw
        self._packed(which)  # raises when that direction was not packed
        # the stripe format's natural view only where the stripe kernel runs
        stripe = None if scatter_admits(host) else getattr(self, f"nat_{which}")
        return route_tr_spmv(host, self.device, stripe, self.perm_t)

    @functools.cached_property
    def route_tr(self):
        """``route_tr_spmv`` of the A pack, ``(name, fmt, call)``, its
        format in natural order; the scatter pack is built on first use."""
        return self._route("tr")

    @functools.cached_property
    def route_fw(self):
        """``route_tr_spmv`` of the A.T pack (for ``mul``; lazy)."""
        return self._route("fw")

    def _apply(self, route, x, alpha, beta, y):
        _, fmt, call = route
        return call(fmt, x, alpha, beta, y)  # alpha/beta fused, natural order

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on the operator's device
        (reference ``mul!(y, A', x, alpha, beta)``, with ``alpha``
        applied), through the kernel :func:`route_tr_spmv` picks."""
        return self._apply(self.route_tr, x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on the operator's device
        (scatter-free: the routed kernel on the A.T pack)."""
        return self._apply(self.route_fw, x, alpha, beta, y)

    def tr_mul_chain(self, x, n_iters: int, alpha=None):
        """y = (alpha * A.T)^n_iters @ x — iterative TrSpMV in one launch
        of the persistent chain kernel (``ops/chain.py``) for every
        ``MAX_LAUNCH_ITERS`` (2^31 - 1) iterations, whatever the plan;
        alpha scales every iteration.

        The operator must be square (``ValueError`` otherwise).
        ``n_iters == 0`` returns a copy of ``x``.  An auto-RCM operator
        gathers x into permuted space once, runs the whole chain there
        and gathers y out once."""
        fmt = self._packed("tr")
        if self.m != self.n:
            raise ValueError(f"tr_mul_chain needs a square operator, got "
                             f"{self.m}x{self.n}")
        if n_iters < 0:
            raise ValueError(f"n_iters must be >= 0, got {n_iters}")
        _check_vec("x", x, self.m, self.device)
        if n_iters == 0:
            return x.clone()
        if self.row_perm is None:
            return tr_spmv_chain(fmt, x, n_iters, alpha)
        out = tr_spmv_chain(fmt, gather(x, self.perm_t), n_iters, alpha)
        return gather(out, self.inv_t)

    def tr_mul_mat(self, X):
        """Y = A.T @ X for a dense RHS ``X [m, k]`` on the operator's
        device (SpMM; reference ``mul!(Y, A', X)``)."""
        return tr_spmm(self.nat_tr, X)

    def mul_mat(self, X):
        """Y = A @ X for a dense RHS ``X [n, k]`` on the operator's device
        (scatter-free: the SpMM kernel on the A.T pack)."""
        return tr_spmm(self.nat_fw, X)

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)


@dataclasses.dataclass(frozen=True)
class VBC2DOperator:
    """Sparse matrix operator in 2-D VBC form (u x w dense tiles) on one
    torch device (reference ``SparseMatrixVBC{U,W}``,
    ``src/SparseMatrixVBCs.jl:57-84`` + ``src/multiply_VBC.jl``).

    ``tr_mul`` runs the tile kernel on the pack of A; ``mul`` is
    scatter-free like the 1-D operator: ``A.T`` is packed 2-D with U and
    W swapped and runs the same kernel.  ``tr_mul_mat``/``mul_mat`` run
    the SpMM kernel on the 1-D view of the same packs, built on the
    device on first use and sharing the 2-D format's values."""

    m: int
    n: int
    host_tr: object | None  # VBC2D of A (for A.T @ x)
    host_fw: object | None  # VBC2D of A.T (for A @ x)
    device: torch.device
    dev_tr: VBC2DDevice | None
    dev_fw: VBC2DDevice | None

    # ---- construction ----------------------------------------------------

    @staticmethod
    def from_csc(
        A,
        U: int = 8,
        W: int = 8,
        method=None,
        method_forward=None,
        directions: str = "both",
        *,
        device,
    ) -> "VBC2DOperator":
        """Plan + pack ``A`` (and/or ``A.T``) into 2-D VBC and copy the
        packs to ``device``.

        ``method`` plans (rows, columns) of A with heights <= U and
        widths <= W; ``method_forward`` plans A.T with heights <= W and
        widths <= U.  Both default to the five-pass alternating
        min-memory planner (``default_2d_partitioner``).
        ``directions``: "both" | "transposed" (A.T@x only) | "forward".
        """
        if directions not in ("both", "transposed", "forward"):
            raise ValueError(f"unknown directions {directions!r}")
        if U < 1 or W < 1:
            raise ValueError(f"U and W must be >= 1, got U={U}, W={W}")
        A = _as_csc(A)
        _check_f32(A)
        host_tr = host_fw = None
        if directions in ("both", "transposed"):
            host_tr = vbc2d(A, U, W, method)
        if directions in ("both", "forward"):
            host_fw = vbc2d(A.transpose(), W, U, method_forward)
        return VBC2DOperator.from_host(host_tr, host_fw, device)

    @staticmethod
    def from_host(host_tr, host_fw, device) -> "VBC2DOperator":
        """Operator over existing packs (this port's or the JAX package's
        ``VBC2D``): ``host_tr`` packs A, ``host_fw`` packs A.T, either may
        be None."""
        device = torch.device(device)
        m, n = _shape_of(host_tr, host_fw)
        return VBC2DOperator(
            m=m, n=n, host_tr=host_tr, host_fw=host_fw, device=device,
            dev_tr=None if host_tr is None else VBC2DDevice.from_host(host_tr, device),
            dev_fw=None if host_fw is None else VBC2DDevice.from_host(host_fw, device),
        )

    @property
    def shape(self):
        return (self.m, self.n)

    def memory_bytes(self) -> int:
        return sum(h.memory_bytes() for h in (self.host_tr, self.host_fw)
                   if h is not None)

    @functools.cached_property
    def view_tr(self) -> VBC1DDevice:
        """The 1-D view of the A pack on the device (SpMM; lazy)."""
        return self._packed("tr").view_1d()

    @functools.cached_property
    def view_fw(self) -> VBC1DDevice:
        """The 1-D view of the A.T pack on the device (SpMM; lazy)."""
        return self._packed("fw").view_1d()

    def _packed(self, which: str) -> VBC2DDevice:
        fmt = self.dev_tr if which == "tr" else self.dev_fw
        if fmt is None:
            name = "transposed" if which == "tr" else "forward"
            raise ValueError(f"operator packed without the {name} direction")
        return fmt

    # ---- compute ---------------------------------------------------------

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on the operator's device
        (reference ``mul!(y, B', x, alpha, beta)`` 2-D,
        ``src/multiply_VBC.jl:104-189``, with ``alpha`` applied)."""
        return tr_spmv_2d(self._packed("tr"), x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on the operator's device
        (scatter-free: the tile kernel on the 2-D pack of A.T)."""
        return tr_spmv_2d(self._packed("fw"), x, alpha, beta, y)

    def tr_mul_mat(self, X):
        """Y = A.T @ X for a dense RHS ``X [m, k]`` (the SpMM kernel on
        the 1-D view)."""
        return tr_spmm(self.view_tr, X)

    def mul_mat(self, X):
        """Y = A @ X for a dense RHS ``X [n, k]`` (the SpMM kernel on the
        1-D view of the A.T pack)."""
        return tr_spmm(self.view_fw, X)

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)
