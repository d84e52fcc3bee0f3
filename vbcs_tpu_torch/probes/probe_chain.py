"""Probe 3: the fused chained SpMV on the card, split into its floor, its
gather and its carry.

Port of ``bench_tools/probe_chain.py``.  Its Pallas kernel runs a grid
``(n_iters, T)``: iteration ``i`` reads the x slot ``i % 2`` (``xin`` at
``i = 0``), computes each chunk's ``res [W, NS]`` and writes it to the
other slot (and to ``out`` at the last iteration).  The state is
``x [8, X]``, ``X = T * NS``.  For column ``c`` of chunk ``t = c // NS``,
slice ``v``, with ``m`` the metadata at ``[s, c]``:

* ``A`` (floor): ``res[w, c] = sum_s val[8 w + s, c] + x[w, b + c % 128]
  * 0``, ``b = wbase[t * 16]``: the value stream and a window read, no
  gather;
* ``B`` (full, ``wblk = 2``): ``xg[s, c] = x[A, b + lo]`` with ``lo = m &
  127``, ``d = (m >> 7) & 3`` (0 at ``wblk = 1``), ``b = wbase[(t * 8 + v)
  * wblk + d]`` and ``A = (m[s, t * NS + v * 128 + lo] >> (16 + 3 d)) & 7``
  (the sublane table read at the gathered lane), then ``res[w, c] = 0.999 *
  sum_s val[8 w + s, c] * xg[s, c]``;
* ``C``: ``B`` at ``wblk = 1``;
* ``D``: ``B`` plus the carry: lane 0 of chunk ``t > 0`` adds ``B``'s
  last lane of chunk ``t - 1`` in the same iteration.

:func:`chain` runs all ``n_iters`` iterations in one cooperative launch of
``csrc/probe_chain.cu`` on CUDA tensors and :func:`chain_plain` on CPU
tensors.  The kernel's blocks own the column ranges of :func:`plan`, each
holding its share of the pack (and its gather positions, decoded once) in
shared memory across iterations, with the x windows it gathers from
copied in at each iteration.  The probe reports the marginal time of
an iteration by the difference of ``N_LO`` and ``N_HI`` iterations, as
the TPU probe does.  Values grow by about ``2.8`` an iteration, so long
chains overflow to inf, on the TPU too: only short chains are compared.

Run on the card:  python -m vbcs_tpu_torch.probes.probe_chain
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _lib
from ._common import card, cuda_device, marginal_ms, report, warm_up

__all__ = ["ChainInputs", "ChainPlan", "inputs", "VARIANTS", "units", "plan", "grid",
           "chain", "chain_plain", "library_matrix", "run", "main"]

NG = NS = 1024  # columns of a chunk (the TPU probe's NG and NS)
W = 8
T = 40
NV = NG // 128
N_LO, N_HI = 20, 220  # the difference method's chain lengths
# the TPU probe's variants, in its order -> (variant, windows a slice)
VARIANTS = [
    ("A chain floor (val+meta+red, no gthr)", "A", 2),
    ("B FULL v3 chain (2take,wblk=2)", "B", 2),
    ("C FULL v3 chain (2take,wblk=1)", "C", 1),
    ("D FULL v3 + carry chain", "D", 2),
]
_CODES = {"A": 0, "B": 1, "C": 2, "D": 3}
# shared bytes a resident column (64 values, 8 positions) and a staged x
# window (128 lanes, its start): csrc/probe_chain.cu kColBytes, kWinBytes
COL_BYTES = 4 * (64 + 8)
WIN_BYTES = 4 * (128 + 1)
_grids: dict = {}  # (device index, variant, budget) -> (blocks, budget)


class ChainInputs(NamedTuple):
    """The chain probe's inputs, on one device."""

    val: torch.Tensor  # [64, X] f32
    meta: torch.Tensor  # [8, X] int32: lo | d << 7 | A0 << 16 | A1 << 19
    xin: torch.Tensor  # [8, X] f32
    wbase: torch.Tensor  # [T * NV * wblk] int32 window lanes, multiples of 128
    wblk: int

    def to(self, device) -> "ChainInputs":
        return ChainInputs(*(t.to(device) for t in self[:4]), self.wblk)


def inputs(T: int = T, wblk: int = 2) -> ChainInputs:
    """The TPU probe's inputs (``run_variant``), on the CPU."""
    rng = np.random.default_rng(0)
    X = T * NS
    val = rng.standard_normal((8 * W, T * NG)).astype(np.float32)
    lo = rng.integers(0, 128, (8, T * NG)).astype(np.int32)
    d = rng.integers(0, wblk, (8, T * NG)).astype(np.int32)
    A = rng.integers(0, 8, (8, T * NG, 2)).astype(np.int32)
    meta = lo | (d << 7) | (A[..., 0] << 16) | (A[..., 1] << 19)
    xin = rng.standard_normal((8, X)).astype(np.float32)
    wbase = (rng.integers(0, X // 128, (T * NV * wblk,)) * 128).astype(np.int32)
    return ChainInputs(*(torch.from_numpy(a) for a in (val, meta, xin, wbase)), wblk)


class ChainPlan(NamedTuple):
    """The kernel's blocks: block ``b`` owns columns ``[lo[b], lo[b + 1])``,
    of which the first ``resident[b]`` (and, where ``halo[b]``, column
    ``lo[b] - 1``) live in shared memory with the ``windows[b]`` x windows
    they gather from, ``bytes[b]`` in all; the rest, ``spill[b]``, are read
    from global memory every iteration."""

    lo: np.ndarray  # [G + 1] int64
    resident: np.ndarray  # [G] int64
    halo: np.ndarray  # [G] bool
    windows: np.ndarray  # [G] int64
    bytes: np.ndarray  # [G] int64

    @property
    def spill(self) -> np.ndarray:
        return np.diff(self.lo) - self.resident


def units(variant: str, wblk: int) -> tuple[int, int]:
    """``(U, K)``: a variant's x windows come in units of ``U`` columns,
    ``K`` windows of 128 lanes a unit (A: a chunk's first window of each
    row; B-D: a slice's ``wblk`` windows of each row)."""
    return (NS, 8) if variant == "A" else (128, 8 * wblk)


def plan(X: int, blocks: int, budget: int, variant: str, wblk: int) -> ChainPlan:
    """The column ranges of a launch of ``blocks`` blocks at ``budget``
    bytes of shared memory each on ``X`` columns, as the kernel computes
    them: ranges balanced to within one column, each block's first columns
    resident, as many as fit with the windows they gather from; for D a
    range starting at a chunk start ``t * NS > 0`` also holds the halo
    column before it (the carry), if it holds any column."""
    if blocks < 1 or budget < 0 or X < 0:
        raise ValueError(f"need blocks >= 1, budget >= 0, X >= 0; got {blocks}, "
                         f"{budget}, {X}")
    U, K = units(variant, wblk)
    lo = np.arange(blocks + 1, dtype=np.int64) * X // blocks
    resident, halo, windows = (np.zeros(blocks, np.int64), np.zeros(blocks, bool),
                               np.zeros(blocks, np.int64))
    for b in range(blocks):
        c0, n = int(lo[b]), int(lo[b + 1] - lo[b])
        h = int(variant == "D" and c0 % NS == 0 and c0 > 0)

        def nwin(nr):
            return ((c0 + nr - 1) // U - (c0 - h) // U + 1) * K

        def fits(nr):
            return nr == 0 or (nr + h) * COL_BYTES + nwin(nr) * WIN_BYTES <= budget
        a, z = 0, n  # the most resident columns that fit (a binary search)
        while a < z:
            mid = a + (z - a + 1) // 2
            a, z = (mid, z) if fits(mid) else (a, mid - 1)
        resident[b], halo[b] = a, a > 0 and h
        windows[b] = nwin(a) if a else 0
    return ChainPlan(lo, resident, halo, windows,
                     (resident + halo) * COL_BYTES + windows * WIN_BYTES)


def _check(variant: str, inp: ChainInputs, n_iters: int) -> None:
    if variant not in _CODES:
        raise ValueError(f"unknown chain variant {variant!r}")
    if n_iters < 1 or n_iters > 2**31 - 1:
        raise ValueError(f"n_iters must be in [1, 2^31), got {n_iters}")
    val, meta, xin, wbase = inp[:4]
    dev = val.device
    X = val.shape[1] if val.dim() == 2 else 0
    if val.dtype != torch.float32 or val.shape != (8 * W, X) or X % NS or X == 0 \
            or 8 * W * X >= 2**31 or not val.is_contiguous():
        raise ValueError(f"val must be contiguous f32 [64, T * {NS}], 64 X < 2^31")
    if meta.dtype != torch.int32 or meta.shape != (8, X) or not meta.is_contiguous():
        raise ValueError(f"meta must be contiguous int32 [8, {X}]")
    if xin.dtype != torch.float32 or xin.shape != (8, X) or not xin.is_contiguous():
        raise ValueError(f"xin must be contiguous f32 [8, {X}]")
    # A reads wbase[t * 16] whatever wblk is
    windows = 2 if variant == "A" else inp.wblk
    if wbase.dtype != torch.int32 or wbase.numel() < (X // NS) * NV * windows \
            or inp.wblk not in (1, 2):
        raise ValueError("wbase must be int32 with wblk (1 or 2) windows a slice "
                         "(A: 2)")
    if any(t.device != dev for t in (meta, xin, wbase)):
        raise ValueError("the inputs must lie on one device")


def grid(device, variant: str, budget: int = -1) -> tuple[int, int]:
    """``(blocks, budget)`` of a launch of ``variant`` on the CUDA
    ``device``: every block the occupancy API fits at ``budget`` bytes of
    shared memory a block (``-1``: the largest a block may take), cached
    per device.  Raises ``RuntimeError`` for a budget over the device's
    limit."""
    dev = torch.device(device)
    key = (dev.index, variant, budget)
    if key not in _grids:
        b, n = ctypes.c_int(budget), ctypes.c_int(0)
        _lib.launch(None, "vbcs_probe_chain_grid", dev, _CODES[variant], ctypes.byref(b),
                    ctypes.byref(n), name="probe chain grid")
        _grids[key] = (n.value, b.value)
    return _grids[key]


def chain(variant: str, inp: ChainInputs, n_iters: int, blocks: int | None = None,
          budget: int | None = None) -> torch.Tensor:
    """``out [W, X]`` after ``n_iters`` iterations of the chain probe
    ``variant``: one cooperative launch on CUDA tensors, the plain version
    on CPU tensors.  ``budget``: shared bytes a block (default the largest
    a block may take); ``blocks``: the grid (default every block the
    occupancy API fits at that budget).  A grid or budget the card cannot
    take raises ``RuntimeError``; nothing falls back."""
    _check(variant, inp, n_iters)
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if budget is not None and budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    dev = inp.val.device
    if dev.type == "cpu":
        return chain_plain(variant, inp, n_iters)
    if dev.type != "cuda":
        raise NotImplementedError(f"no chain probe kernel for device {dev}")
    if inp.xin.data_ptr() % 16:
        raise ValueError("xin must start on 16 bytes (the kernel reads it as float4)")
    X = inp.val.shape[1]
    fit, budget = grid(dev, variant, -1 if budget is None else budget)
    blocks = fit if blocks is None else blocks
    out = torch.empty(W, X, dtype=torch.float32, device=dev)
    slots = torch.empty(2, 8, X, dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    _lib.launch(chain, "vbcs_probe_chain", dev, _CODES[variant], n_iters, X // NS,
                inp.wblk, inp.val.data_ptr(), inp.meta.data_ptr(), inp.xin.data_ptr(),
                inp.wbase.data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
                out.data_ptr(), count.data_ptr(), 0, blocks, budget,
                name=f"probe chain {variant}")
    return out


chain.launches = 0


def _gather(inp: ChainInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """The full body's gather: ``xg[s, c] = x.reshape(-1)[pos[s, c]]`` where
    ``keep[s, c]``, else 0 (``pos``, ``keep``: ``[8, X]``)."""
    meta, wbase = inp.meta, inp.wbase.long()
    dev, X = meta.device, meta.shape[1]
    c = torch.arange(X, device=dev)
    t, v = c // NS, (c % NS) // 128
    m = meta.long() & 0xFFFFFFFF
    lo = m & 127
    d = torch.zeros_like(m) if inp.wblk == 1 else (m >> 7) & 3
    dc = d.clamp(max=inp.wblk - 1)
    b = wbase[(t * NV + v) * inp.wblk + dc]
    a = (m.gather(1, t * NG + v * 128 + lo) >> (16 + 3 * dc)) & 7
    return a * X + b + lo, d < inp.wblk


def _step(variant: str, inp: ChainInputs, x: torch.Tensor) -> torch.Tensor:
    """One iteration of the plain chain: ``res [W, X]`` from ``x [8, X]``."""
    val = inp.val
    dev, X = val.device, val.shape[1]
    if variant == "A":
        c = torch.arange(X, device=dev)
        red = val.view(W, 8, X).sum(1)
        lane = inp.wbase.long()[(c // NS) * NV * 2] + c % 128
        return red + x[:W, lane] * 0.0
    pos, keep = _gather(inp)
    xg = torch.where(keep, x.reshape(-1)[pos], torch.zeros((), device=dev))
    red = (val.view(W, 8, X) * xg.unsqueeze(0)).sum(1) * 0.999
    if variant == "D":
        red[:, NS::NS] = red[:, NS::NS] + red[:, NS - 1:X - 1:NS]
    return red


def chain_plain(variant: str, inp: ChainInputs, n_iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`chain` (any device)."""
    _check(variant, inp, n_iters)
    x = inp.xin
    for _ in range(n_iters):
        x = _step(variant, inp, x)
    return x


def library_matrix(variant: str, inp: ChainInputs) -> torch.Tensor:
    """An iteration of the full body (``B``, or ``C`` at ``wblk = 1``) as
    the sparse matrix it applies to x: ``M`` (f32 CSR, ``[W X, 8 X]``) with
    ``0.999 * M @ x.reshape(-1)`` equal to one iteration's ``res``,
    flattened, up to the order of each sum.  The library yardstick
    (``torch.addmv(z, M, x, beta=0, alpha=0.999)`` an iteration), built on
    ``inp``'s device; the port never calls it.  ``A`` adds a constant and
    ``D`` a carry, so neither is this one product."""
    if variant not in ("B", "C"):
        raise ValueError(f"variant {variant} is not a product of val and a gather of x")
    val = inp.val
    dev, X = val.device, val.shape[1]
    pos, keep = _gather(inp)
    rows = (torch.arange(W, device=dev)[:, None, None] * X
            + torch.arange(X, device=dev)[None, None, :]).expand(W, 8, X)
    keep = keep.unsqueeze(0).expand(W, 8, X)
    cols = pos.unsqueeze(0).expand(W, 8, X)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  val.view(W, 8, X)[keep], (W * X, 8 * X))
    return coo.coalesce().to_sparse_csr()


def run(device, barrier_floor_ms: float | None = None) -> list[dict]:
    """The marginal device time of one iteration of each variant on the
    CUDA ``device`` (``probes._common.marginal_ms`` of ``N_LO`` and
    ``N_HI`` iterations).  Returns one record per variant, with
    ``barrier_floor_ms`` (an iteration of the chain kernel's barrier
    floor, measured by the caller) where it is given."""
    out = []
    for name, var, wblk in VARIANTS:
        inp = inputs(T, wblk).to(device)
        ms = marginal_ms(lambda n, var=var, inp=inp: chain(var, inp, n),
                         N_LO, N_HI, device)
        rec = {"name": name, "variant": var, "ms": ms, "T": T,
               # per iteration: the pack is read once a call
               "bytes": 0, "flops": 2 * inp.val.numel()}
        if barrier_floor_ms is not None:
            rec["barrier_floor_ms"] = barrier_floor_ms
        out.append(rec)
    return out


def print_records(records, device) -> None:
    for r in records:
        print(report(r["name"], r["ms"], device, r["bytes"], r["flops"],
                     chunks=r["T"], nnz=r["T"] * NG * 8 * W, unit="iteration"),
              flush=True)


def main() -> None:
    device = cuda_device()
    print(card(device), flush=True)
    warm_up(device)
    print_records(run(device), device)


if __name__ == "__main__":
    main()
