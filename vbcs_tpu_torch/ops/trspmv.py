"""Stripe TrSpMV: ``y = alpha * A.T @ x (+ beta * y)`` on a VBC1DDevice.

Port of ``vbcs_tpu/ops/pallas_trspmv3.py``'s one-shot path
(``tr_spmv_oneshot3``; Pallas kernel ``_oneshot_kernel``).  On a CUDA
tensor :func:`tr_spmv` launches the hand-written kernel in
``csrc/trspmv.cu``; on a CPU tensor it runs :func:`tr_spmv_plain`, the
plain PyTorch version of the same function.

Alpha/beta follow the JAX kernel: ``alpha=None`` is 1; ``beta * y`` is
added only when both ``beta`` and ``y`` are given.

``out=`` writes into a given buffer through the format's ``col_out``, an
injection into ``[0, out.numel())``: two launches on two formats whose
``col_out`` are disjoint fill one buffer (the overlapped halo path's
local and remote stripes, ``parallel/stream.py``).

The kernel has two thread maps, picked here from the format
(:func:`thread_map`): the float4 map where every stripe width is a
multiple of 4 (``quad_widths``), the values are f32 and they start on 16
bytes; else the staged map, a thread block a run of stripes
(:func:`stage_plan`).

A format holds f32 or f64 values (``VBC1DDevice.from_host``'s
``dtype``), and x, y and the output are in the same dtype.  f64 runs the
staged map in double on every format (``csrc/trspmv.cu``'s
``vbcs_tr_spmv_f64``: a stage holds half as many values and block rows).
Each launch is counted by its map in ``utils.trace``'s always-on counter
``launches_by_map`` (:func:`utils.trace.launches_by_map`): ``quad`` and
``staged`` count f32 launches, ``staged_f64`` the f64 ones.
"""

from __future__ import annotations

import torch

from ..formats.device import VBC1DDevice
from ..utils import trace
from . import _lib

__all__ = ["tr_spmv", "tr_spmv_plain", "stage_plan", "stage_elements", "thread_map",
           "check_tensor", "STAGE_COLS", "STAGE_STRIPES", "STAGE_WORDS"]

# the staged map's run bounds (csrc/trspmv.cu: kRunCols, kRunStripes,
# kStageWords): two passes of a block's 256 threads, a column a thread;
# the run's splits; its values and gathered x rows in one shared-memory
# stage of 4-byte words
STAGE_COLS = 512
STAGE_STRIPES = 256
STAGE_WORDS = 7168


def stage_elements(dtype: torch.dtype) -> int:
    """Values and block rows a run stages in ``dtype`` (one element of
    the value type each, in ``STAGE_WORDS`` 4-byte words): 7,168 in f32,
    3,584 in f64 (``csrc/trspmv.cu``: ``kStageElems``)."""
    return STAGE_WORDS * 4 // torch.empty(0, dtype=dtype).element_size()


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device,
                 dtype=torch.float32) -> None:
    """Refuse what the kernels do not take: anything but a contiguous
    tensor of ``dtype`` and ``shape`` (``None`` matches any extent) on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, "
                        f"got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        want = ", ".join("k" if w is None else str(w) for w in shape)
        want += "," if len(shape) == 1 else ""
        raise ValueError(f"{name} must have shape ({want}), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tr_spmv_plain(fmt, x: torch.Tensor, alpha=None, beta=None,
                  y=None, out=None) -> torch.Tensor:
    """Plain PyTorch TrSpMV: ``index_add_`` of ``val * x[row]`` into the
    value's column, in the values' dtype.  ``fmt`` is any device format
    with ``n``, ``val`` and ``value_coords`` (computed once per format);
    with ``out``, the columns land in it at ``col_out`` and its other
    entries are kept."""
    row, col = fmt.value_coords
    acc = torch.zeros(fmt.n if out is None else out.numel(), dtype=fmt.val.dtype,
                      device=x.device)
    acc.index_add_(0, col, fmt.val * x[row])
    if alpha is not None:
        acc = acc * alpha
    if y is not None and beta is not None:
        acc = acc + beta * y
    if out is None:
        return acc
    place = (torch.arange(fmt.n, device=out.device) if fmt.col_out is None
             else fmt.col_out.long())
    out[place] = acc[place]
    return out


def _check_out(fmt, out) -> None:
    """``out`` must hold every output column: ``n`` entries in natural
    order, at least ``n`` under ``col_out`` (an injection into them), in
    the format's dtype."""
    check_tensor("out", out, (None,), fmt.device, fmt.val.dtype)
    if out.numel() < fmt.n or (fmt.col_out is None and out.numel() != fmt.n):
        raise ValueError(f"out has {out.numel()} entries for {fmt.n} columns "
                         f"({'placed by col_out' if fmt.col_out is not None else 'in order'})")


def _run_tr_spmv(kernel, plain, fmt, x, alpha, beta, y, launch,
                 out=None) -> torch.Tensor:
    """The body every TrSpMV wrapper shares.  Checks ``x`` (and ``y`` when
    ``beta`` is given; shaped like the output), each in the dtype of the
    format's values, runs ``plain`` on a CPU tensor, and on a CUDA
    tensor allocates the output (unless ``out`` is given: only
    :func:`tr_spmv` takes one) and calls ``launch(y_in, alpha, beta,
    out)`` (device pointers and the scalars), which launches ``kernel``
    through ``_lib.launch``."""
    dev, dtype = fmt.device, fmt.val.dtype
    with trace.span("op.check"):
        check_tensor("x", x, (fmt.m,), dev, dtype)
        if out is not None:
            _check_out(fmt, out)
        with_y = y is not None and beta is not None
        if with_y:
            check_tensor("y", y, (fmt.n if out is None else out.numel(),), dev, dtype)
    if dev.type == "cpu":
        if out is None:
            return plain(fmt, x, alpha, beta, y)
        return plain(fmt, x, alpha, beta, y, out)
    if dev.type != "cuda":
        raise NotImplementedError(f"no {kernel.__name__} kernel for device {dev}")
    if out is None:
        with trace.span("op.alloc"):
            out = torch.empty(fmt.n, dtype=dtype, device=dev)
    if fmt.n == 0:
        return out
    with trace.span("op.launch"):
        launch(y.data_ptr() if with_y else None, 1.0 if alpha is None else float(alpha),
               float(beta) if with_y else 0.0, out.data_ptr())
    return out


def _cut_runs(spl: torch.Tensor, pos: torch.Tensor, ofs: torch.Tensor,
              cols: int, stripes: int, words: int) -> torch.Tensor:
    """:func:`stage_plan`'s runs of the stripes split by ``spl``/``pos``/
    ``ofs`` (int64) at the given bounds."""
    L, dev = spl.numel() - 1, spl.device
    s = torch.arange(L + 1, device=dev)
    used = ofs + pos  # stage words before each stripe split
    nxt = torch.minimum(
        torch.searchsorted(spl, spl + cols, right=True),
        torch.searchsorted(used, used + words, right=True)) - 1
    nxt = torch.minimum(nxt, s + stripes)
    nxt = torch.maximum(nxt, s + 1).clamp_(max=L)  # a stripe at least; L stays
    jumps = [nxt]  # jumps[k][s]: the split 2^k runs on from split s
    while int(jumps[-1][0]) < L:
        jumps.append(jumps[-1][jumps[-1]])
    on = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    on[0] = True
    for jump in reversed(jumps):
        on[jump[on]] = True
    runs = torch.nonzero(on).flatten()
    return torch.stack([runs, spl[runs], pos[runs], ofs[runs]], 1).int().contiguous()


def stage_plan(fmt: VBC1DDevice) -> torch.Tensor:
    """The staged map's runs of ``fmt``, a thread block of the kernel a run:
    int32 ``[R + 1, 4]`` on its device, each split between runs as (stripe,
    column, block, value), so a block reads where its run starts and ends
    in two 16-byte loads.

    Cut greedily from stripe 0: each run takes whole consecutive stripes
    for as long as it holds at most ``STAGE_COLS`` columns,
    ``STAGE_STRIPES`` stripes and :func:`stage_elements` elements of
    stage in the format's dtype (its values and its block rows, one
    element each: ``STAGE_WORDS`` in f32, half as many in f64), so no run
    but the last could take its next stripe.  A stripe beyond the stage
    alone is a run of its own (the kernel walks it in passes of columns
    and chunks of blocks); one beyond ``STAGE_COLS`` too.  Computed with
    torch ops (each stripe's longest run, then the runs from stripe 0 by
    pointer doubling) once per format arrays and stage, and cached in
    ``fmt.stage_plans``, which a natural view shares."""
    elems = stage_elements(fmt.val.dtype)
    hit = fmt.stage_plans.get(("runs", elems))
    if hit is not None and hit[0] is fmt.spl and hit[1] is fmt.pos and hit[2] is fmt.ofs:
        return hit[3]
    plan = _cut_runs(fmt.spl.long(), fmt.pos.long(), fmt.ofs.long(), STAGE_COLS,
                     STAGE_STRIPES, elems)
    fmt.stage_plans[("runs", elems)] = (fmt.spl, fmt.pos, fmt.ofs, plan)
    return plan


def thread_map(fmt) -> str:
    """The kernel's thread map on ``fmt``: ``"quad"`` or ``"staged"``
    (the module docstring; an f64 format is always ``"staged"``)."""
    return ("quad" if fmt.quad_widths and fmt.val.dtype == torch.float32
            and fmt.val.data_ptr() % 16 == 0 else "staged")


def tr_spmv(fmt: VBC1DDevice, x: torch.Tensor, alpha=None, beta=None,
            y=None, out=None) -> torch.Tensor:
    """``alpha * A.T @ x (+ beta * y)`` in natural order, shape ``[n]``
    (on a natural view, output column ``j`` lands at ``col_out[j]``).
    With ``out`` (``[k]``), column ``j`` lands at ``out[col_out[j]]``
    (``col_out`` an injection into ``[0, k)``, unchecked on the card;
    ``k = n`` without one) and ``out`` is returned; ``y``, where given,
    is shaped like it.  x, y, ``out`` and the result are in the dtype of
    the format's values, f32 or f64.

    CUDA tensors run the stripe kernel (or raise); CPU tensors run
    :func:`tr_spmv_plain`."""

    def launch(*tail):
        f64 = fmt.val.dtype == torch.float64
        how = thread_map(fmt)
        runs = stage_plan(fmt) if how == "staged" else None
        _lib.launch(tr_spmv, "vbcs_tr_spmv_f64" if f64 else "vbcs_tr_spmv", fmt.device,
                    fmt.n, fmt.L, 0 if runs is None else runs.shape[0] - 1, _lib.ptr(runs),
                    fmt.spl.data_ptr(), fmt.pos.data_ptr(), fmt.idx.data_ptr(),
                    fmt.ofs.data_ptr(), _lib.ptr(fmt.col_out), fmt.val.data_ptr(),
                    x.data_ptr(), *tail)
        trace.tally("launches_by_map", "staged_f64" if f64 else how)

    return _run_tr_spmv(tr_spmv, tr_spmv_plain, fmt, x, alpha, beta, y, launch, out)


tr_spmv.launches = 0
