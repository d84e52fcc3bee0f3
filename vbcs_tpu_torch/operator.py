"""VBCOperator and VBC2DOperator — the user-facing sparse operators.

Port of ``vbcs_tpu/operator.py``.  ``from_csc``
plans and packs ``A`` (and ``A.T``) on the host as the JAX operator
does — the min-memory DP and ``pack_1dvbc`` — with an auto-RCM decision
of its own (RCM where it shrinks the packs held; the JAX operator decides
by an estimate of its TPU kernel's x windows), then copies the packs to a
torch ``device`` (the card, ``"cuda"``, unless the caller asks for another):

* ``tr_mul``: ``y = alpha * A.T @ x + beta * y`` through the kernel
  :func:`route_tr_spmv` picks for the pack — the stripe kernel
  (``ops/trspmv.py``) or, on unstructured packs, the column-parallel
  scatter kernel (``ops/scatter.py``) — alpha/beta fused into its store;
* ``mul``: ``y = alpha * A @ x + beta * y``, the same route on the
  column-striped ``A.T`` (scatter-free), or the ordered scatter on A's
  own pack (below);
* ``tr_mul_chain``: ``y = (alpha * A.T)^k @ x`` for a square operator, one
  launch of the persistent chain kernel (``ops/chain.py``);
* ``tr_mul_mat``/``mul_mat``: ``Y = A.T @ X`` and ``Y = A @ X`` for a
  dense RHS ``X [rows, k]``, through the stripe SpMM kernel
  (``ops/spmm.py``) on the same two packs, or ``mul_mat`` by the ordered
  scatter;
* the forward products (``mul``, ``mul_mat``) have two formulations:
  the gather on A.T's pack above, which reads an X entry for every block
  of that pack, and the ordered scatter on A's pack (``ops/ordered.py``),
  which reads X once and writes each block's row of products to Y or to
  a slot summed in a second launch.  :func:`forward_pack` picks one from
  the packs by the bytes a call moves (:func:`forward_bytes`); an f32
  "forward" operator holds the pack it picks (``fw_on_a``) for both
  calls, an f32 "both" operator runs ``mul_mat`` on the pick and ``mul``
  on A.T's pack, and one of another dtype holds A.T's;
* auto-RCM operators hold ``A[perm][:, perm]`` and run ``tr_mul``,
  ``mul``, ``tr_mul_mat`` and ``mul_mat`` on its natural views
  (``natural_view``: rows ``perm[idx]``, output column ``j`` at
  ``perm[j]``), one launch a call with no gather; ``tr_mul_chain`` runs
  the relabeled pack, where its shared-memory x window relies on the
  RCM's locality, with ``perm`` folded into the chain kernel (a gather of
  x before its first iteration, one of y after its last: one launch, no
  gather kernel either).

``VBC2DOperator.from_csc`` plans and packs the 2-D format (the
alternating planner and ``pack_vbc2d``) of ``A`` and of ``A.T`` with U
and W swapped; ``tr_mul``/``mul`` run the kernel
:func:`route_tr_spmv_2d` picks for each pack — the tile kernel
(``ops/trspmv2d.py``), or the stripe kernel on the pack's 1-D view where
its tiles are mostly one row high (:func:`tile2d_worthwhile`) —
``tr_mul_mat``/``mul_mat`` the SpMM kernel on the 1-D views, as the JAX
operator does.

Every kernel writes natural order, so nothing follows it.

Which calls run a kernel is one table, ``_KERNEL_DTYPES``: by operator
and kind of call, the matrix dtypes a kernel takes.  A call runs its
kernel when x is a tensor of the matrix's dtype and that dtype is in the
table for the call; the kernels' formats are copied to the device for
the dtypes the table lists for the operator.  f32 runs every call (the
JAX operators' ``_pallas_ok``); f64 runs the 1-D operator's
``tr_mul``/``mul``, the stripe kernel's f64 staged map (``ops/trspmv.py``)
on the f64 copy of the pack, alpha/beta/y fused in f64 — a departure from
``_pallas_ok``, which sends every f64 call to XLA; the results agree
within f64 rounding.  :func:`route_tr_spmv` alone picks the kernel of a
1-D pack, from its dtype and the scatter guard: an f64 pack takes the
stripe kernel whatever the guard says, since the scatter kernel is f32's
alone (the f64 DP cuts HPCG's stencil into stripes 1.98 wide, under the
guard's 2.0, where the f32 DP leaves 2.02).  Every other call runs
``ops/semiring.py`` in x's dtype on the pack's flat
:class:`SemiringDevice` (natural coordinates on an auto-RCM operator),
with alpha/beta/y applied after it as the JAX operators' ``_axpby``
does, on CPU and CUDA tensors alike: an int32 or bool matrix; a matrix
and x of different dtypes; and in f64 ``tr_mul_chain``,
``tr_mul_mat``/``mul_mat`` and every :class:`VBC2DOperator` call.  Each
such call is counted by its product's dtype
(``utils.trace.semiring_calls``) and runs in an ``op.semiring`` span.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .api import default_1d_partitioner, vbc2d
from .formats.csc import CSC
from .formats.device import SemiringDevice, VBC1DDevice, VBC2DDevice
from .formats.vbc1d import VBC1D, pack_1dvbc
from .ops import semiring
from .ops.chain import tr_spmv_chain
from .ops.ordered import SECTOR_COLUMNS, mul_ordered
from .ops.scatter import pack_scatter, tr_spmv_scatter
from .ops.spmm import tr_spmm
from .ops.trspmv import check_tensor, tr_spmv
from .ops.trspmv2d import tr_spmv_2d
from .plan.alternating import pack_stripe
from .plan.reorder import rcm_symmetric
from .utils import trace

__all__ = ["VBCOperator", "VBC2DOperator", "route_tr_spmv", "route_tr_spmv_2d",
           "mean_tile_height", "tile2d_worthwhile", "TILE2D_MIN_HEIGHT",
           "forward_bytes", "forward_pack"]

# The 2-D route's one threshold: a pack whose stored values sit in tiles
# at least this tall on average runs the tile kernel, a flatter one the
# stripe kernel on its 1-D view (GUARD 2-D data on an H100, PERF.md).
TILE2D_MIN_HEIGHT = 2.0

# the tracer's root span of each call, by direction (utils/trace.py)
_VEC_SPANS = {"tr": "op.tr_mul", "fw": "op.mul"}
_MAT_SPANS = {"tr": "op.tr_mul_mat", "fw": "op.mul_mat"}

# The one route table: by operator ("1d", "2d") and kind of call ("vec":
# tr_mul/mul, "mat": tr_mul_mat/mul_mat, "chain": tr_mul_chain), the
# matrix dtypes whose calls run a kernel.  A call runs it when x is a
# tensor of the matrix's dtype and that dtype is listed; every other call
# takes the semiring route.  An operator copies the kernels' formats of a
# matrix whose dtype one of its calls runs.
_KERNEL_DTYPES = {
    ("1d", "vec"): (torch.float32, torch.float64),
    ("1d", "mat"): (torch.float32,),
    ("1d", "chain"): (torch.float32,),
    ("2d", "vec"): (torch.float32,),
    ("2d", "mat"): (torch.float32,),
}


def route_tr_spmv(B, device, stripe: VBC1DDevice | None = None,
                  perm: torch.Tensor | None = None):
    """The per-call TrSpMV kernel :meth:`VBCOperator.tr_mul` runs for a
    packed f32 or f64 format ``B`` — ``(name, fmt, call)`` with
    ``call(fmt, x, alpha, beta, y) -> y`` — for harnesses that must time
    the shipped path, and the only place that picks the scatter or the
    stripe kernel.

    It reads ``B``'s dtype once and asks the scatter guard once
    (``ops.scatter.pack_scatter``: mean stripe width below
    ``MAX_MEAN_WIDTH``): ``"scatter"`` (the entry-tiled kernel on ``B``'s
    CSC) for an f32 ``B`` the guard admits, else ``"stripe"``; an f64
    ``B`` always ``"stripe"`` (its f64 staged map), since the scatter
    kernel is f32's alone.  The JAX package tries its one-shot first and
    reaches the scatter tier only when that pack refuses; the port's
    stripe kernel refuses nothing, so the guard alone decides.  ``stripe``
    is ``B`` already on ``device`` (in ``B``'s dtype), reused instead of a
    second copy, as it is when it is already a natural view.  ``perm``
    (int32 on ``device``) says that ``B`` packs ``A[perm][:, perm]``: the
    route's format is then the natural view of its pack
    (``natural_view``), whose call reads natural x and writes natural y."""
    f64 = np.asarray(B.val).dtype == np.float64
    fmt = None if f64 else pack_scatter(B, device)
    if fmt is not None:
        return ("scatter", fmt if perm is None else fmt.natural_view(perm),
                tr_spmv_scatter)
    if stripe is None:
        stripe = VBC1DDevice.from_host(B, device, torch.float64 if f64 else torch.float32)
    if perm is not None and stripe.col_out is None:
        stripe = stripe.natural_view(perm)
    return "stripe", stripe, tr_spmv


def forward_bytes(host, formulation: str, k: int = 1) -> int:
    """Bytes a forward product ``A @ X`` of ``k`` RHS columns moves on the
    host pack ``host``, as the card's kernels read it: the pack's stored
    bytes (``memory_bytes()``) and, for ``"A.T"`` (``host`` packs A.T,
    the gather of ``ops/spmm.py``/``ops/trspmv.py``), 4 bytes of x a
    block and 4 of y a row of A, a column; for ``"A"`` (``host`` packs A,
    the ordered scatter of ``ops/ordered.py``), the map it reads (4 bytes
    a block and a row) and, a column, x once, y once, and the product of
    each block that goes through a slot written and read back (4 bytes
    each): every block below ``SECTOR_COLUMNS`` columns (by block), else
    those in a row of A with two blocks or more."""
    if formulation == "A.T":
        return host.memory_bytes() + 4 * k * (host.num_blocks + host.n)
    if formulation != "A":
        raise ValueError(f"unknown formulation {formulation!r}")
    slotted = host.num_blocks
    if k >= SECTOR_COLUMNS:
        per_row = np.bincount(np.asarray(host.idx, dtype=np.int64), minlength=host.m)
        slotted = int(per_row[per_row >= 2].sum())
    maps = 4 * (host.num_blocks + host.m + 1)
    return host.memory_bytes() + maps + 4 * k * (host.n + 2 * slotted + host.m)


def forward_pack(host_a, host_at) -> str:
    """The pack the forward products of an f32 operator run on: ``"A"``
    (the ordered scatter on ``host_a``, a pack of A) where it moves fewer
    bytes than the gather on ``host_at``, a pack of A.T (the two may be
    one pack, of a symmetric A), both for one column (``mul``) and a
    column of a wide X (``mul_mat``: the bytes a column adds from
    ``SECTOR_COLUMNS`` on, where the stored bytes weigh nothing); else
    ``"A.T"``."""
    def column(host, formulation):
        return (forward_bytes(host, formulation, SECTOR_COLUMNS + 1)
                - forward_bytes(host, formulation, SECTOR_COLUMNS))

    one = forward_bytes(host_a, "A") < forward_bytes(host_at, "A.T")
    wide = column(host_a, "A") < column(host_at, "A.T")
    return "A" if one and wide else "A.T"


def _equal(A: CSC, B: CSC) -> bool:
    """Whether two CSC matrices (rows sorted in each column) are equal,
    pattern and values."""
    return ((A.m, A.n) == (B.m, B.n) and np.array_equal(A.pos, B.pos)
            and np.array_equal(A.idx, B.idx) and np.array_equal(A.val, B.val))


def mean_tile_height(B2) -> float:
    """The mean, over a 2-D pack's stored values, of the height of the
    tile that holds each: ``sum(u^2 w) / sum(u w)`` over its tiles (0 for
    a pack with no stored value)."""
    u = np.diff(np.asarray(B2.Pi.spl, dtype=np.int64))[np.asarray(B2.idx)]
    w = np.repeat(np.diff(np.asarray(B2.Phi.spl, dtype=np.int64)),
                  np.diff(np.asarray(B2.pos, dtype=np.int64)))
    stored = int((u * w).sum())
    return float((u * u * w).sum()) / stored if stored else 0.0


def tile2d_worthwhile(B2) -> bool:
    """The single source of truth for the 2-D route, which both
    :func:`route_tr_spmv_2d` and :class:`VBC2DOperator` ask (so the
    autotuner times the kernel ``tr_mul`` runs): the tile kernel when the
    pack's :func:`mean_tile_height` is at least :data:`TILE2D_MIN_HEIGHT`,
    else the stripe kernel on the 1-D view, which reads 4 bytes a block
    row where the tile format reads 8 a one-row tile.  The JAX package's
    guard (``_v3_view_worthwhile``) compares Mosaic exit plans the port
    does not have; this one is a statistic of the pack."""
    return mean_tile_height(B2) >= TILE2D_MIN_HEIGHT


def route_tr_spmv_2d(B2, device, fmt: VBC2DDevice | None = None):
    """The per-call TrSpMV kernel :meth:`VBC2DOperator.tr_mul` runs for a
    packed f32 2-D format ``B2`` — ``(name, fmt, call)`` with
    ``call(fmt, x, alpha, beta, y) -> y``: ``"tile2d"`` (the tile kernel)
    when :func:`tile2d_worthwhile`, else ``"view"`` (the stripe kernel on
    the pack's 1-D view, alpha/beta/y fused).  ``fmt`` is ``B2`` already
    on ``device``, reused instead of a second copy."""
    if fmt is None:
        fmt = VBC2DDevice.from_host(B2, device)
    if tile2d_worthwhile(B2):
        return "tile2d", fmt, tr_spmv_2d
    return "view", fmt.view_1d(), tr_spmv


def _times(t: torch.Tensor, s):
    """``t * s`` as JAX promotes it with 64-bit types on: an integer
    tensor times a Python float is f64."""
    if isinstance(s, float) and not t.is_floating_point():
        t = t.double()
    return t * s


def _axpby(out, alpha, beta, y):
    """alpha*out + beta*y on the semiring route, as the JAX operators'
    ``_axpby`` applies it after their XLA kernels."""
    if alpha is not None:
        out = _times(out, alpha)
    if y is not None and beta is not None:
        semiring.check_operand("y", y, out.shape[0], out.device, 1)
        out = out + _times(y, beta)
    return out


def _dtype_of(host) -> torch.dtype:
    """A host pack's value dtype, as torch's."""
    return torch.from_numpy(np.empty(0, np.asarray(host.val).dtype)).dtype


def _kernel_dtype(kind: str, host) -> torch.dtype | None:
    """The dtype the kernels' format of ``host`` is copied in for an
    operator of ``kind``: the matrix's own, where one of the operator's
    calls runs it on a kernel (``_KERNEL_DTYPES``); else None."""
    if host is None:
        return None
    dtype = _dtype_of(host)
    runs = any(dtype in dtypes for (k, _), dtypes in _KERNEL_DTYPES.items() if k == kind)
    return dtype if runs else None


def _as_csc(A) -> CSC:
    return A if isinstance(A, CSC) else CSC.from_scipy(A)


def _shape_of(host_tr, host_fw) -> tuple[int, int]:
    """(m, n) of the operator over the packs of A and of A.T (either may
    be None); refuses a pair that do not transpose."""
    host = host_tr if host_tr is not None else host_fw
    if host is None:
        raise ValueError("need at least one of host_tr and host_fw")
    m, n = (host.m, host.n) if host is host_tr else (host.n, host.m)
    if host_tr is not None and host_fw is not None and (
            host_fw.m, host_fw.n) != (n, m):
        raise ValueError("host_fw must pack the transpose of host_tr")
    return int(m), int(n)


class _Directions:
    """What both operators share: a pack of each direction on the host,
    the kernels' formats of those packs (None for a matrix no kernel
    runs), the route table's answer for each call and, built on first
    use, their flat semiring formats."""

    _kind = ""  # the operator's key in _KERNEL_DTYPES
    fw_on_a = False  # the forward products on A's pack (VBCOperator's field)

    def _host(self, which: str):
        """The host pack of A (``"tr"``) or of A.T (``"fw"``) that serves
        that direction, or of A (``"a"``) that serves the forward products
        of a ``fw_on_a`` operator; ``ValueError`` when the operator was
        packed without the direction (A's pack of a forward ``fw_on_a``
        operator serves no transposed product)."""
        host = self.host_fw if which == "fw" else self.host_tr
        if which == "tr" and self.fw_on_a and self.host_fw is None:
            host = None
        if host is None:
            name = "transposed" if which == "tr" else "forward"
            raise ValueError(f"operator packed without the {name} direction")
        return host

    def _packed(self, which: str):
        """The kernels' format of one pack (``"tr"``, ``"fw"``, ``"a"``, as
        :meth:`_host`): ``ValueError`` when that direction was not packed,
        ``TypeError`` for a matrix no kernel runs (whose calls take the
        semiring route)."""
        host = self._host(which)
        fmt = self.dev_fw if which == "fw" else self.dev_tr
        if fmt is None:
            raise TypeError(f"no kernel runs this operator's "
                            f"{np.asarray(host.val).dtype} matrix")
        return fmt

    @functools.cached_property
    def _dtype(self) -> torch.dtype:
        """The matrix's dtype (its packs' values)."""
        return _dtype_of(self.host_tr if self.host_tr is not None else self.host_fw)

    def _kernel_takes(self, call: str, x) -> bool:
        """Whether a call of kind ``call`` runs its kernel on ``x``: x a
        tensor of the matrix's dtype, that dtype in ``_KERNEL_DTYPES`` for
        the call; else the call takes the semiring route in x's dtype."""
        return (isinstance(x, torch.Tensor) and x.dtype == self._dtype
                and x.dtype in _KERNEL_DTYPES[self._kind, call])

    @functools.cached_property
    def semi_tr(self) -> SemiringDevice:
        """The A pack flat for ``ops/semiring.py``, in the matrix's dtype
        and natural coordinates (built on first use)."""
        return SemiringDevice.from_host(self._host("tr"), device=self.device,
                                        perm=getattr(self, "perm_t", None))

    @functools.cached_property
    def semi_fw(self) -> SemiringDevice:
        """The A.T pack flat for ``ops/semiring.py`` (see :attr:`semi_tr`);
        on a ``fw_on_a`` operator that holds none, A's pack flat and
        transposed."""
        if self.fw_on_a and self.host_fw is None:
            return SemiringDevice.from_host(self._host("a"), device=self.device,
                                            perm=self.perm_t).transposed()
        return SemiringDevice.from_host(self._host("fw"), device=self.device,
                                        perm=getattr(self, "perm_t", None))

    def _semiring(self, fn, which: str, x):
        """``fn`` (an ``ops/semiring.py`` product) on one direction's
        flat format, in an ``op.semiring`` span, counted by x's dtype."""
        with trace.span("op.semiring"):
            out = fn(getattr(self, f"semi_{which}"), x)
        trace.tally("semiring_calls", str(x.dtype).removeprefix("torch."))
        return out

    def _apply(self, which, x, alpha, beta, y):
        """``tr_mul``/``mul`` of one direction: the routed kernel with
        alpha/beta fused, or the semiring route and ``_axpby``."""
        with trace.span(_VEC_SPANS[which]):
            if not self._kernel_takes("vec", x):
                return _axpby(self._semiring(semiring.tr_spmv, which, x), alpha, beta, y)
            _, fmt, call = getattr(self, f"route_{which}")
            return call(fmt, x, alpha, beta, y)


def _transpose(A: CSC) -> CSC:
    with trace.span("plan.transpose"):
        return A.transpose()


def _plan(labellings, W, method, method_forward, holds):
    """The candidate packs of an operator, each planned and packed once:
    ``holds`` lists the sets of packs (``"A"``, ``"A.T"``) the operator
    may hold; for each labelling ``(matrix, perm)`` every pack a set
    names (A.T's is A's where the matrix equals its transpose and one
    method plans both).  Returns, for each set, ``(packs, perm)`` of the
    labelling whose packs in the set store the fewest bytes summed (the
    first, natural, on a tie)."""
    need = set().union(*holds)
    cands = []
    for M, perm in labellings:
        packs = {}
        if "A" in need:
            packs["A"] = pack_1dvbc(M, pack_stripe(M, method), W)
        if "A.T" in need:
            Mt = _transpose(M)
            packs["A.T"] = (packs["A"] if "A" in packs and method is method_forward
                            and _equal(M, Mt)
                            else pack_1dvbc(Mt, pack_stripe(Mt, method_forward), W))
        cands.append((packs, perm))
    return [min(cands, key=lambda c: sum(c[0][p].memory_bytes() for p in held))
            for held in holds]


@dataclasses.dataclass(frozen=True)
class VBCOperator(_Directions):
    """Sparse matrix operator in 1D-VBC form on one torch device."""

    _kind = "1d"

    m: int
    n: int
    host_tr: VBC1D | None  # column-striped A (for A.T @ x)
    host_fw: VBC1D | None  # column-striped A.T (for A @ x)
    device: torch.device
    dev_tr: VBC1DDevice | None
    dev_fw: VBC1DDevice | None
    row_perm: np.ndarray | None = None  # symmetric relabeling (auto-RCM)
    perm_t: torch.Tensor | None = None  # int32 perm on device
    # mul_mat runs the ordered scatter on host_tr (A's pack); with no
    # host_fw the operator serves mul there too, and no transposed product
    fw_on_a: bool = False

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
        device="cuda",
    ) -> "VBCOperator":
        """Plan + pack ``A`` (and/or ``A.T``) and copy the packs to ``device``.

        ``directions``: "both" | "transposed" (A.T@x only) | "forward".
        ``method`` plans the columns of A; ``method_forward`` the columns
        of A.T (defaults to ``method``).

        ``reorder``: "auto" applies a *symmetric* RCM relabeling to a
        square ``A`` of more than 1,024 rows where it shrinks the packs the
        operator holds: both candidates' packs are built (RCM computed
        once), and the relabeled ones are kept iff their summed
        ``memory_bytes()`` is strictly less (a tie keeps ``A``): A's pack
        for "transposed", all four for "both", and for "forward" the packs
        of each formulation on their own (A.T's, and A's where the
        forward products may run on it).  Every call but
        ``tr_mul_chain`` runs a relabeled pack's natural view, whose x and
        y locality is never better than the unrelabeled pack's, so RCM
        pays on the card only by storing fewer bytes.  The JAX operator
        decides by its TPU window estimate instead
        (``plan.reorder.window_badness``), so the two may differ.  Each
        decision is counted (``utils.trace.reorder_choices``).
        "never"/"always" force it off/on.  The operator carries the
        permutation and applies it at the call boundaries.

        The forward products of an f32 matrix run on the pack
        :func:`forward_pack` picks (counted by
        ``utils.trace.forward_choices``): a "forward" operator plans A's
        pack too (once, when ``A`` equals its transpose and one method
        plans both) and holds only the pack picked, which runs ``mul``
        and ``mul_mat``; a "both" operator plans nothing more and picks
        from the two it holds for ``mul_mat``, its ``mul`` staying on
        A.T's pack.  A matrix of another dtype keeps A.T's pack.
        """
        with trace.span("from_csc"):
            if directions not in ("both", "transposed", "forward"):
                raise ValueError(f"unknown directions {directions!r}")
            if reorder not in ("auto", "always", "never"):
                raise ValueError(f"unknown reorder {reorder!r}")
            A = _as_csc(A)
            method = method or default_1d_partitioner(W, A.val.dtype.itemsize)
            method_forward = method_forward or method
            relabels = A.m == A.n and A.m > 1024  # RCM applies
            decide = reorder == "auto" and relabels

            def labellings():
                """(matrix, perm) of each candidate labelling, RCM computed
                once and after the natural candidates are planned."""
                if reorder != "always" or not relabels:
                    yield A, None
                if reorder != "never" and relabels:
                    yield rcm_symmetric(A)

            # the forward products of an f32 matrix may run on A's pack
            weigh = directions != "transposed" and A.val.dtype == np.float32
            holds = {"transposed": [("A",)], "both": [("A", "A.T")],
                     "forward": [("A.T",), ("A",)] if weigh else [("A.T",)]}[directions]
            plans = _plan(labellings(), W, method, method_forward, holds)
            packs, row_perm = plans[0]
            host_tr = packs["A"] if "A" in holds[0] else None
            host_fw = packs["A.T"] if "A.T" in holds[0] else None
            fw_on_a = (weigh and directions == "both"
                       and forward_pack(host_tr, host_fw) == "A")
            if weigh and directions == "forward":
                a_packs, perm_a = plans[1]
                if forward_pack(a_packs["A"], host_fw) == "A":
                    host_tr, host_fw, row_perm, fw_on_a = a_packs["A"], None, perm_a, True
            if decide:
                trace.tally("reorder_choices", "natural" if row_perm is None else "rcm")
            if weigh:
                trace.tally("forward_choices", "A" if fw_on_a else "A.T")
            return VBCOperator.from_host(host_tr, host_fw, row_perm, device,
                                         fw_on_a=fw_on_a)

    @staticmethod
    def from_host(host_tr, host_fw, row_perm, device="cuda", *,
                  fw_on_a: bool = False) -> "VBCOperator":
        """Operator over existing packs (this port's or the JAX package's
        ``VBC1D``): ``host_tr`` packs A, ``host_fw`` packs A.T, either may
        be None; ``row_perm`` is the symmetric relabeling the packs were
        built under, or None, carried on the device as the int32
        ``perm_t`` (its inverse is ``torch.argsort(perm_t)``).  The
        kernels' formats are copied, in the matrix's own dtype, for a
        dtype that ``_KERNEL_DTYPES`` lists for one of the operator's
        calls (f32, f64).

        ``fw_on_a``: ``mul_mat`` runs the ordered scatter on ``host_tr``
        (an f32 pack of A), whose maps are built here, on the device; with
        ``host_fw`` None the operator is a forward one, whose ``mul`` runs
        there too (its transposed products raise as they do with no
        ``host_tr``)."""
        with trace.span("plan.upload"):
            device = torch.device(device)
            m, n = _shape_of(host_tr, host_fw)
            if fw_on_a and (host_tr is None or _dtype_of(host_tr) != torch.float32):
                raise ValueError("fw_on_a needs an f32 pack of A (host_tr)")
            perm_t = None
            if row_perm is not None:
                row_perm = np.asarray(row_perm, dtype=np.int64)
                if m != n or not np.array_equal(np.sort(row_perm), np.arange(m)):
                    raise ValueError("row_perm must be a permutation of range(m) "
                                     "of a square operator")
                perm_t = torch.from_numpy(row_perm.astype(np.int32)).to(device)

            def copy(host):
                dtype = _kernel_dtype("1d", host)
                return None if dtype is None else VBC1DDevice.from_host(host, device, dtype)

            op = VBCOperator(
                m=m, n=n, host_tr=host_tr, host_fw=host_fw, device=device,
                dev_tr=copy(host_tr), dev_fw=copy(host_fw),
                row_perm=row_perm, perm_t=perm_t, fw_on_a=fw_on_a,
            )
            if fw_on_a:
                op.ordered_fw.ordered_maps  # built once, with the copy
            return op

    @property
    def shape(self):
        return (self.m, self.n)

    def memory_bytes(self) -> int:
        """The packs' bytes, and the ordered scatter's maps where the
        forward products run on A's pack (its row -> blocks map once a
        call below ``SECTOR_COLUMNS`` columns has built it)."""
        total = 0
        if self.host_tr is not None:
            total += self.host_tr.memory_bytes()
        if self.host_fw is not None:
            total += self.host_fw.memory_bytes()
        if self.fw_on_a:
            total += self.ordered_fw.ordered_bytes()
        return total

    # ---- compute ---------------------------------------------------------

    @functools.cached_property
    def nat_tr(self) -> VBC1DDevice:
        """The A pack in natural order: ``dev_tr``, or on an auto-RCM
        operator its natural view (built on first use)."""
        with trace.span("op.route"):
            fmt = self._packed("tr")
            if self.fw_on_a:
                return self.ordered_fw  # the same view (built by from_host)
            return fmt if self.perm_t is None else fmt.natural_view(self.perm_t)

    @functools.cached_property
    def nat_fw(self) -> VBC1DDevice:
        """The A.T pack in natural order (see :attr:`nat_tr`)."""
        with trace.span("op.route"):
            fmt = self._packed("fw")
            return fmt if self.perm_t is None else fmt.natural_view(self.perm_t)

    @functools.cached_property
    def route_tr(self):
        """``route_tr_spmv`` of the A pack, ``(name, fmt, call)``, its
        format in natural order (built on first use): the route takes
        :attr:`nat_tr` as its stripe format."""
        stripe = self.nat_tr
        with trace.span("op.route"):
            return route_tr_spmv(self.host_tr, self.device, stripe, self.perm_t)

    @functools.cached_property
    def ordered_fw(self) -> VBC1DDevice:
        """The A pack the ordered scatter runs ``mul``/``mul_mat`` on
        (:attr:`nat_tr`, natural order; ``fw_on_a`` operators only), its
        maps built by ``from_host``."""
        if not self.fw_on_a:
            raise ValueError("the forward products run on the A.T pack")
        with trace.span("op.route"):
            fmt = self._packed("a")
            return fmt if self.perm_t is None else fmt.natural_view(self.perm_t)

    @functools.cached_property
    def route_fw(self):
        """``mul``'s route, ``(name, fmt, call)`` (lazy): ``route_tr_spmv``
        of the A.T pack, or on a ``fw_on_a`` operator that holds none,
        ``"ordered"``, the ordered scatter on :attr:`ordered_fw`."""
        if self.fw_on_a and self.host_fw is None:
            return "ordered", self.ordered_fw, mul_ordered
        stripe = self.nat_fw
        with trace.span("op.route"):
            return route_tr_spmv(self.host_fw, self.device, stripe, self.perm_t)

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on the operator's device
        (reference ``mul!(y, A', x, alpha, beta)``, with ``alpha``
        applied), through the kernel :func:`route_tr_spmv` picks for an
        f32 or f64 matrix and an x of its dtype (``_KERNEL_DTYPES``); else
        the semiring route."""
        return self._apply("tr", x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on the operator's device: the
        routed kernel on the A.T pack, or on a ``fw_on_a`` operator with
        none the ordered scatter on A's (:attr:`route_fw`)."""
        return self._apply("fw", x, alpha, beta, y)

    def tr_mul_chain(self, x, n_iters: int, alpha=None):
        """y = (alpha * A.T)^n_iters @ x — iterative TrSpMV in one launch
        of the persistent chain kernel (``ops/chain.py``) for every
        ``MAX_LAUNCH_ITERS`` (2^31 - 1) iterations, whatever the plan;
        alpha scales every iteration.

        The operator must be square (``ValueError`` otherwise).
        ``n_iters == 0`` returns a copy of ``x``.  An auto-RCM operator
        runs the whole chain in permuted space, the chain kernel gathering
        x through ``perm`` before it and y after it (``tr_spmv_chain``'s
        ``perm``: one launch, no gather kernel).  A non-f32 matrix or x runs the JAX
        operators' loop instead (``tr_mul``, then alpha rounded to f32,
        each iteration)."""
        with trace.span("op.tr_mul_chain"):
            self._host("tr")  # raises when that direction was not packed
            if self.m != self.n:
                raise ValueError(f"tr_mul_chain needs a square operator, got "
                                 f"{self.m}x{self.n}")
            if n_iters < 0:
                raise ValueError(f"n_iters must be >= 0, got {n_iters}")
            if not self._kernel_takes("chain", x):
                return self._semiring_chain(x, n_iters, alpha)
            fmt = self._packed("tr")
            check_tensor("x", x, (self.m,), self.device)
            if n_iters == 0:
                return x.clone()
            return tr_spmv_chain(fmt, x, n_iters, alpha, self.perm_t)

    def _semiring_chain(self, x, n_iters: int, alpha):
        """The JAX operators' ``fori_loop`` of ``tr_mul`` and ``* alpha``
        (alpha as an f32 scalar), which raises ``TypeError`` when alpha
        would turn an integer x into a float carry; one semiring call."""
        semiring.check_operand("x", x, self.m, self.device, 1)
        if alpha is not None and not x.is_floating_point():
            raise TypeError(f"alpha turns the {x.dtype} iterate into a float "
                            f"one (the JAX loop refuses the change of type)")
        a = None if alpha is None else float(np.float32(alpha))

        def loop(fmt, x):
            out = x.clone()
            for _ in range(n_iters):
                out = semiring.tr_spmv(fmt, out)
                if a is not None:
                    out = out * a
            return out

        return self._semiring(loop, "tr", x)

    def _apply_mat(self, which, X):
        with trace.span(_MAT_SPANS[which]):
            if not self._kernel_takes("mat", X):
                return self._semiring(semiring.tr_spmm, which, X)
            if which == "fw" and self.fw_on_a:
                return mul_ordered(self.ordered_fw, X)
            return tr_spmm(getattr(self, f"nat_{which}"), X)

    def tr_mul_mat(self, X):
        """Y = A.T @ X for a dense RHS ``X [m, k]`` on the operator's
        device (SpMM; reference ``mul!(Y, A', X)``)."""
        return self._apply_mat("tr", X)

    def mul_mat(self, X):
        """Y = A @ X for a dense RHS ``X [n, k]`` on the operator's device:
        the SpMM kernel on the A.T pack, or on a ``fw_on_a`` operator the
        ordered scatter on A's."""
        return self._apply_mat("fw", X)

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)


@dataclasses.dataclass(frozen=True)
class VBC2DOperator(_Directions):
    """Sparse matrix operator in 2-D VBC form (u x w dense tiles) on one
    torch device (reference ``SparseMatrixVBC{U,W}``,
    ``src/SparseMatrixVBCs.jl:57-84`` + ``src/multiply_VBC.jl``).

    ``tr_mul`` runs the kernel :func:`route_tr_spmv_2d` picks for the
    pack of A (the tile kernel, or the stripe kernel on its 1-D view);
    ``mul`` is scatter-free like the 1-D operator: ``A.T`` is packed 2-D
    with U and W swapped and takes its own route.  ``tr_mul_mat``/
    ``mul_mat`` run the SpMM kernel on the 1-D view of the same packs,
    built on the device on first use and sharing the 2-D format's
    values.  A non-f32 matrix or x takes the semiring route."""

    _kind = "2d"

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
        device="cuda",
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
        with trace.span("from_csc"):
            A = _as_csc(A)
            host_tr = host_fw = None
            if directions in ("both", "transposed"):
                host_tr = vbc2d(A, U, W, method)
            if directions in ("both", "forward"):
                with trace.span("plan.transpose"):
                    At = A.transpose()
                host_fw = vbc2d(At, W, U, method_forward)
            return VBC2DOperator.from_host(host_tr, host_fw, device)

    @staticmethod
    def from_host(host_tr, host_fw, device="cuda") -> "VBC2DOperator":
        """Operator over existing packs (this port's or the JAX package's
        ``VBC2D``): ``host_tr`` packs A, ``host_fw`` packs A.T, either may
        be None."""
        with trace.span("plan.upload"):
            device = torch.device(device)
            m, n = _shape_of(host_tr, host_fw)

            def copy(host):
                return (None if _kernel_dtype("2d", host) is None
                        else VBC2DDevice.from_host(host, device))

            return VBC2DOperator(m=m, n=n, host_tr=host_tr, host_fw=host_fw,
                                 device=device, dev_tr=copy(host_tr),
                                 dev_fw=copy(host_fw))

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

    @functools.cached_property
    def route_tr(self):
        """``route_tr_spmv_2d`` of the A pack, ``(name, fmt, call)`` (lazy;
        the view route shares :attr:`view_tr`)."""
        with trace.span("op.route"):
            return route_tr_spmv_2d(self._host("tr"), self.device, self._packed("tr"))

    @functools.cached_property
    def route_fw(self):
        """``route_tr_spmv_2d`` of the A.T pack (for ``mul``; lazy)."""
        with trace.span("op.route"):
            return route_tr_spmv_2d(self._host("fw"), self.device, self._packed("fw"))

    # ---- compute ---------------------------------------------------------

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on the operator's device
        (reference ``mul!(y, B', x, alpha, beta)`` 2-D,
        ``src/multiply_VBC.jl:104-189``, with ``alpha`` applied), through
        the kernel :func:`route_tr_spmv_2d` picks."""
        return self._apply("tr", x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on the operator's device
        (scatter-free: the routed kernel on the 2-D pack of A.T)."""
        return self._apply("fw", x, alpha, beta, y)

    def _apply_mat(self, which, X):
        with trace.span(_MAT_SPANS[which]):
            if not self._kernel_takes("mat", X):
                return self._semiring(semiring.tr_spmm, which, X)
            return tr_spmm(getattr(self, f"view_{which}"), X)

    def tr_mul_mat(self, X):
        """Y = A.T @ X for a dense RHS ``X [m, k]`` (the SpMM kernel on
        the 1-D view)."""
        return self._apply_mat("tr", X)

    def mul_mat(self, X):
        """Y = A @ X for a dense RHS ``X [n, k]`` (the SpMM kernel on the
        1-D view of the A.T pack)."""
        return self._apply_mat("fw", X)

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)
