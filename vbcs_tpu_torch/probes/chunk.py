"""The chunk probe kernel (``csrc/probe_chunk.cu``) and its plain version.

One kernel stands for the Pallas bodies of two TPU probes,
``bench_tools/probe_kernel.py`` (``run_variant.kern``) and
``bench_tools/probe_kernel2.py`` (``run_variant.kern``).  Both work on the
flagship stripe kernel's chunk: ``NG = 1024`` columns of ``8 * W = 64``
value rows, ``T`` chunks, and write ``out [8, T * NG]``.  Each Hopper
variant computes what one or more Pallas bodies compute, on the same
inputs (:class:`ChunkInputs`); bodies that compute the same function in
different ways on the TPU (5, 5b, 5c) share one variant.  The index maps,
for output row ``s`` and column ``c`` of chunk ``g = c // NG``, slice
``v = (c % NG) // 128``, lane ``l = c % 128``, with ``r`` the metadata at
``[s, c]`` read as uint32 (the TPU's logical shifts):

* ``stream``: ``val[s] + val[8 + s]``; streams every row of ``val`` and
  the metadata (as the Pallas pipeline does) but needs rows 0-15;
* ``probe_kernel`` windows ``win(k) = x[8 * tab[k] : 8 * tab[k] + 8]``
  (``tab`` is ``xtile``, 3 windows a slice, ``k = (g * 8 + v) * 3 + d``):
  ``ladder`` ``win(k(d = hi // 8))[hi % 8, lo]`` with ``hi = r >> 7``,
  ``lo = r & 127`` (0 when ``d >= 3``); ``sub3`` ``win(k(r >> 10))[s,
  lo]``; ``sub1`` ``win(k(0))[s, lo]``; ``roll`` as ``sub1`` from row
  ``s + 1`` (mod 8) where ``r >> 10`` is not 0; ``wide`` ``win((g * 8 +
  (r & 1023) // 128) * 3)[s, r & 127]``; ``axis0`` ``win(k(0))[(r >> 7) &
  7, l]``; ``const`` (the x of ``const_red``) ``win(g * 24)[s, l]``;
* ``probe_kernel2`` windows ``x[tab[k] : tab[k] + 8]`` (``tab`` is
  ``wbase``, ``wblk`` windows a slice): ``winsum`` the sum over the 8
  slices and ``wblk`` windows of chunk ``g`` of ``x[tab[k] + s, l]``;
  ``take2`` ``x[tab[k(d)] + A, lo]`` with ``lo = r & 127``, ``d = r >> 7``
  (0 at ``wblk == 1``; 0 where ``d >= wblk``), ``A = (m1[s, g * NG + v *
  128 + lo] >> 3 d) & 7`` — the second table is read at the lane the
  gather reads, not the output's; ``roll_add`` ``x[(s + 1) % 8, l] +
  val[s, c]``;
* ``*_red``: ``out[w, c] = sum_s val[8 w + s, c] * xg[s, c]`` over the
  gather's ``xg``.

:func:`chunk` launches the kernel on CUDA tensors and runs
:func:`chunk_plain` on CPU tensors.  The kernel does no bounds checks:
the tables must index windows inside ``x`` (the probes' input builders
make them so).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import _lib
from ..utils.timing import flushed_ms, paired_ms
from ._common import report

__all__ = ["ChunkInputs", "VARIANTS", "chunk", "chunk_plain", "needed_bytes",
           "streamed_bytes", "BITWISE", "time_variants", "print_records",
           "library_matrix"]

NG = 1024  # columns of a chunk
W = 8  # stripe width: 8 * W value rows
# Hopper variant -> its code in csrc/probe_chunk.cu
VARIANTS = {"stream": 0, "ladder": 1, "sub3": 2, "sub1": 3, "roll": 4,
            "wide": 5, "axis0": 6, "ladder_red": 7, "const_red": 8,
            "sub3_red": 9, "winsum": 10, "take2": 11, "take2_red": 12,
            "roll_add": 13}
# variants without arithmetic, or with one add: the kernel equals the plain
# version bitwise (the others sum in another order)
BITWISE = {"stream", "ladder", "sub3", "sub1", "roll", "wide", "axis0", "take2",
           "roll_add"}
# the inputs each variant's function reads ("val16": val rows 0-15, "val8"
# rows 0-7, "x8": x rows 0-7), besides its output
_READS = {
    "stream": ("val16",),
    **{v: ("m0", "x", "tab") for v in ("ladder", "sub3", "sub1", "roll", "wide",
                                       "axis0")},
    "ladder_red": ("val", "m0", "x", "tab"),
    "sub3_red": ("val", "m0", "x", "tab"),
    "const_red": ("val", "x", "tab"),
    "winsum": ("x", "tab"),
    "take2": ("m0", "m1", "x", "tab"),
    "take2_red": ("val", "m0", "m1", "x", "tab"),
    "roll_add": ("val8", "x8"),
}


class ChunkInputs(NamedTuple):
    """One chunk probe's inputs, on one device."""

    val: torch.Tensor  # [64, N] f32, N = T * NG
    m0: torch.Tensor  # [8, N] int32 or int16: probe_kernel's row, probe_kernel2's loA
    m1: torch.Tensor | None  # [8, N], the dtype of m0: probe_kernel2's hiA
    x: torch.Tensor  # [rows, 128] f32
    tab: torch.Tensor  # int32: probe_kernel's xtile, probe_kernel2's wbase
    wblk: int  # windows a 128-lane slice

    def to(self, device) -> "ChunkInputs":
        return ChunkInputs(*(None if t is None else t.to(device)
                             for t in self[:5]), self.wblk)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def needed_bytes(variant: str, inp: ChunkInputs) -> int:
    """Bytes the variant's function must move: each input it reads once
    and its output written once."""
    n = inp.val.shape[1]
    sizes = {"val": _bytes(inp.val), "val16": 16 * n * 4, "val8": 8 * n * 4,
             "m0": _bytes(inp.m0), "m1": 0 if inp.m1 is None else _bytes(inp.m1),
             "x": _bytes(inp.x), "x8": 8 * 128 * 4, "tab": _bytes(inp.tab)}
    return sum(sizes[k] for k in _READS[variant]) + 8 * n * 4


def streamed_bytes(variant: str, inp: ChunkInputs) -> int:
    """Bytes the kernel reads and writes: :func:`needed_bytes`, except that
    ``stream`` reads every value row and the metadata, as the Pallas
    pipeline streams them."""
    if variant != "stream":
        return needed_bytes(variant, inp)
    meta = sum(_bytes(t) for t in (inp.m0, inp.m1) if t is not None)
    return _bytes(inp.val) + meta + 8 * inp.val.shape[1] * 4


def _check(variant: str, inp: ChunkInputs) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown chunk variant {variant!r}")
    val, m0, m1, x, tab = inp[:5]
    dev = val.device
    if val.dtype != torch.float32 or val.dim() != 2 or val.shape[0] != 8 * W \
            or val.shape[1] % NG or not val.is_contiguous():
        raise ValueError(f"val must be contiguous f32 [64, T * {NG}], got "
                         f"{val.dtype} {tuple(val.shape)}")
    n = val.shape[1]
    for name, m in (("m0", m0), ("m1", m1)):
        if m is None:
            if name == "m0" or variant in ("take2", "take2_red"):
                raise ValueError(f"{variant} needs {name}")
            continue
        if m.dtype not in (torch.int32, torch.int16) or m.dtype != m0.dtype \
                or m.shape != (8, n) or not m.is_contiguous() or m.device != dev:
            raise ValueError(f"{name} must be contiguous int32 or int16 [8, {n}] "
                             f"on {dev} (both of one dtype)")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 128 \
            or x.shape[0] < 8 or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"x must be contiguous f32 [rows >= 8, 128] on {dev}")
    per_slice = 3 if variant in ("ladder", "sub3", "sub1", "roll", "wide",
                                 "axis0", "ladder_red", "const_red",
                                 "sub3_red") else inp.wblk
    if inp.wblk < 1 or tab.dtype != torch.int32 or tab.dim() != 1 \
            or tab.numel() < (n // NG) * 8 * per_slice or tab.device != dev:
        raise ValueError(f"tab must be int32 with {per_slice} windows for each "
                         f"of the {(n // NG) * 8} slices on {dev}")


def chunk(variant: str, inp: ChunkInputs) -> torch.Tensor:
    """``out [8, N]`` of the chunk probe ``variant`` (see the module
    docstring) on ``inp``: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(variant, inp)
    dev = inp.val.device
    if dev.type == "cpu":
        return chunk_plain(variant, inp)
    if dev.type != "cuda":
        raise NotImplementedError(f"no chunk probe kernel for device {dev}")
    n = inp.val.shape[1]
    out = torch.empty(8, n, dtype=torch.float32, device=dev)
    _lib.launch(chunk, "vbcs_probe_chunk", dev, VARIANTS[variant], n, inp.wblk,
                int(inp.m0.dtype == torch.int16), inp.val.data_ptr(), inp.m0.data_ptr(),
                _lib.ptr(inp.m1), inp.x.data_ptr(), inp.tab.data_ptr(), out.data_ptr(),
                name=f"probe chunk {variant}")
    return out


chunk.launches = 0


def _u32(m: torch.Tensor) -> torch.Tensor:
    """Metadata as the TPU's logical shifts see it: int32 bits, unsigned."""
    return m.to(torch.int64) & 0xFFFFFFFF


def _gather(variant: str, inp: ChunkInputs) -> torch.Tensor:
    """``xg [8, N]``: the x value each (row, column) of the variant reads."""
    val, m0, m1, x, tab = inp[:5]
    dev, n = val.device, val.shape[1]
    c = torch.arange(n, device=dev)
    g, v, l = c // NG, (c % NG) // 128, c % 128
    s = torch.arange(8, device=dev)[:, None]
    xf, tab = x.reshape(-1), tab.long()
    r = _u32(m0)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    def win(k, row, lane):  # probe_kernel: window k = x[8 tab[k] : + 8]
        return xf[(8 * tab[k] + row) * 128 + lane]

    k0 = (g * 8 + v) * 3
    if variant in ("ladder", "ladder_red"):
        hi, lo = r >> 7, r & 127
        d = hi >> 3
        return torch.where(d < 3, win(k0 + d.clamp(max=2), hi & 7, lo), zero)
    if variant in ("sub3", "sub3_red"):
        d, lo = r >> 10, r & 127
        return torch.where(d < 3, win(k0 + d.clamp(max=2), s, lo), zero)
    if variant == "sub1":
        return win(k0, s, r & 127)
    if variant == "roll":
        return win(k0, torch.where((r >> 10) == 0, s, (s + 1) % 8), r & 127)
    if variant == "wide":
        lo = r & 1023
        return win((g * 8 + (lo >> 7)) * 3, s, lo & 127)
    if variant == "axis0":
        return win(k0, (r >> 7) & 7, l)
    if variant == "const_red":
        return win(g * 24, s, l).expand(8, n)
    if variant in ("take2", "take2_red"):
        wblk = inp.wblk
        lo = r & 127
        d = torch.zeros_like(r) if wblk == 1 else r >> 7
        dc = d.clamp(max=wblk - 1)
        b = tab[(g * 8 + v) * wblk + dc]
        a = (_u32(m1).gather(1, g * NG + v * 128 + lo) >> (3 * dc)) & 7
        return torch.where(d < wblk, xf[(b + a) * 128 + lo], zero)
    raise ValueError(f"{variant} has no gather")


def chunk_plain(variant: str, inp: ChunkInputs) -> torch.Tensor:
    """Plain PyTorch version of :func:`chunk` (any device)."""
    _check(variant, inp)
    val, x, tab = inp.val, inp.x, inp.tab.long()
    n = val.shape[1]
    if variant == "stream":
        return val[:8] + val[8:16]
    if variant == "roll_add":
        l = torch.arange(n, device=val.device) % 128
        return x[(torch.arange(8, device=val.device)[:, None] + 1) % 8, l] + val[:8]
    if variant == "winsum":
        c = torch.arange(n, device=val.device)
        g, l = c // NG, c % 128
        s = torch.arange(8, device=val.device)[:, None]
        acc = torch.zeros(8, n, dtype=torch.float32, device=val.device)
        for v in range(8):
            for d in range(inp.wblk):
                acc = acc + x.reshape(-1)[
                    (tab[(g * 8 + v) * inp.wblk + d] + s) * 128 + l]
        return acc
    xg = _gather(variant, inp)
    if variant.endswith("_red"):
        return (val.view(W, 8, n) * xg.unsqueeze(0)).sum(1)
    return xg


def library_matrix(variant: str, inp: ChunkInputs) -> torch.Tensor:
    """A ``*_red`` variant as the sparse matrix it applies to x: ``M`` (f32
    CSR, ``[8 N, x.numel()]``) with ``M @ x.reshape(-1)`` equal to
    ``chunk(variant, inp).reshape(-1)`` up to the order of each sum (an
    output's reads of one x entry are one summed value).  The library
    yardstick (``torch.addmv`` on it), built on ``inp``'s device; the port
    never calls it."""
    if not variant.endswith("_red"):
        raise ValueError(f"{variant} is not a product of val and a gather of x")
    x, n = inp.x, inp.val.shape[1]
    if x.numel() >= 1 << 24:
        raise ValueError("x too large for f32 positions")
    dev = x.device
    # the gather of x's positions + 1 (exact in f32): the x entry each
    # (row, column) reads, 0 where it reads none
    pos = torch.arange(1, x.numel() + 1, dtype=torch.float32, device=dev).view_as(x)
    col = _gather(variant, inp._replace(x=pos)).long() - 1
    rows = (torch.arange(W, device=dev)[:, None, None] * n
            + torch.arange(n, device=dev)[None, None, :]).expand(W, 8, n)
    cols = col.unsqueeze(0).expand(W, 8, n)
    keep = cols >= 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  inp.val.view(W, 8, n)[keep], (W * n, x.numel()))
    return coo.coalesce().to_sparse_csr()


def time_variants(device, variants, inputs) -> list[dict]:
    """Time each TPU variant ``(name, variant, kw)`` of a chunk probe on
    ``inputs(**kw)``, on the CUDA ``device``, warm (``paired_ms``) and with
    L2 flushed (``flushed_ms``); a Hopper variant that several TPU variants
    share on the same inputs is timed once.  Returns one record per TPU
    variant: its name, the Hopper variant, ``ms``, ``flushed_ms``, ``T``,
    ``bytes`` (what the function needs), ``streamed_bytes`` (what the
    kernel moves) and ``flops``."""
    built: dict = {}
    timed: dict = {}
    out = []
    for name, var, kw in variants:
        key = tuple(sorted(kw.items()))
        if key not in built:
            built[key] = inputs(**kw).to(device)
        inp = built[key]
        if (var, key) not in timed:
            def call(var=var, inp=inp):
                return chunk(var, inp)
            timed[var, key] = (paired_ms([call], device)[0], flushed_ms(call, device))
        ms, cold = timed[var, key]
        out.append({"name": name, "variant": var, "ms": ms, "flushed_ms": cold,
                    "T": inp.val.shape[1] // NG, "bytes": needed_bytes(var, inp),
                    "streamed_bytes": streamed_bytes(var, inp),
                    "flops": 2 * inp.val.numel() if var.endswith("_red") else 0})
    return out


def print_records(records, device) -> None:
    """One line a record of :func:`time_variants`."""
    for r in records:
        note = f"[{r['variant']}] flushed {r['flushed_ms'] * 1e3:.2f} us"
        if r["streamed_bytes"] != r["bytes"]:
            note += (f"; moves {r['streamed_bytes'] / 1e6:.2f} MB, needs "
                     f"{r['bytes'] / 1e6:.2f} MB")
        print(report(r["name"], r["ms"], device, r["bytes"], r["flops"],
                     chunks=r["T"], nnz=r["T"] * NG * 8 * W, note=note), flush=True)
