"""Probe: the SpMM v4 design's load path on the card.

Port of ``bench_tools/probe_spmm4.py``, on its inputs
(``numpy.random.default_rng(0)``: X ``[320,001, 128]``, 321,536 random
rows of it, Xg ``[T * 2048, 128]`` and Vl ``[T * 2048, 8]`` at
``T = 157``):

* (a) the row gather ``X[rows]``: on the TPU an XLA gather, here
  ``index_select`` (not a kernel of the port);
* (b) the streaming FMA kernel (``csrc/probe_spmm4.cu``, :func:`fma`):
  ``out[t*2048 + 8p + w, :] = sum_{j<8} Vl[t*2048 + 256j + p, w] *
  Xg[t*2048 + 256j + p, :]``, beside ``torch.einsum`` of the same
  product (the library yardstick; the port never calls it).

Run on the card:  python -m vbcs_tpu_torch.probes.probe_spmm4
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import _lib
from ..utils.timing import paired_ms
from ._common import card, cuda_device, report, warm_up

__all__ = ["Spmm4Inputs", "inputs", "fma", "fma_plain", "fma_library",
           "row_gather", "run", "main"]

M, K = 320_001, 128  # X
N_ROWS = 321_536  # rows gathered
SL, NB = 256, 8  # stripes a chunk, blocks a stripe
RC = SL * NB  # rows a chunk
T = 157


class Spmm4Inputs(NamedTuple):
    X: torch.Tensor  # [m, 128] f32
    rows: torch.Tensor  # [N_ROWS] int32
    Xg: torch.Tensor  # [T * RC, 128] f32
    Vl: torch.Tensor  # [T * RC, 8] f32

    def to(self, device) -> "Spmm4Inputs":
        return Spmm4Inputs(*(t.to(device) for t in self))


def inputs(T: int = T, m: int = M) -> Spmm4Inputs:
    """The TPU probe's inputs, in its order, on the CPU (``m`` rows of X;
    the tests take fewer)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((m, K)).astype(np.float32)
    rows = rng.integers(0, m, N_ROWS).astype(np.int32)
    Xg = rng.standard_normal((T * RC, 128)).astype(np.float32)
    Vl = rng.standard_normal((T * RC, 8)).astype(np.float32)
    return Spmm4Inputs(*(torch.from_numpy(a) for a in (X, rows, Xg, Vl)))


def _check(Xg: torch.Tensor, Vl: torch.Tensor) -> int:
    if Xg.dtype != torch.float32 or Xg.dim() != 2 or Xg.shape[1] != K \
            or Xg.shape[0] % RC or not Xg.is_contiguous():
        raise ValueError(f"Xg must be contiguous f32 [T * {RC}, {K}]")
    if Vl.dtype != torch.float32 or Vl.shape != (Xg.shape[0], 8) \
            or not Vl.is_contiguous() or Vl.device != Xg.device:
        raise ValueError(f"Vl must be contiguous f32 [{Xg.shape[0]}, 8] on "
                         f"Xg's device")
    return Xg.shape[0] // RC


def fma(Xg: torch.Tensor, Vl: torch.Tensor) -> torch.Tensor:
    """``out [T * RC, 128]`` of the FMA (see the module docstring): the CUDA
    kernel on CUDA tensors, :func:`fma_plain` on CPU tensors."""
    n_chunks = _check(Xg, Vl)
    dev = Xg.device
    if dev.type == "cpu":
        return fma_plain(Xg, Vl)
    if dev.type != "cuda":
        raise NotImplementedError(f"no FMA probe kernel for device {dev}")
    if Xg.data_ptr() % 16 or Vl.data_ptr() % 16:
        raise ValueError("Xg and Vl must start on 16 bytes")
    out = torch.empty_like(Xg)
    _lib.launch(fma, "vbcs_probe_spmm4_fma", dev, n_chunks, Xg.data_ptr(), Vl.data_ptr(),
                out.data_ptr(), name="probe spmm4 fma")
    return out


fma.launches = 0


def fma_plain(Xg: torch.Tensor, Vl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma` (any device): the sum over the
    8 blocks, one product at a time."""
    n_chunks = _check(Xg, Vl)
    xg = Xg.view(n_chunks, NB, SL, 1, K)
    vl = Vl.view(n_chunks, NB, SL, 8, 1)
    acc = torch.zeros(n_chunks, SL, 8, K, dtype=torch.float32, device=Xg.device)
    for j in range(NB):
        acc = acc + vl[:, j] * xg[:, j]
    return acc.view(-1, K)


def fma_library(Xg: torch.Tensor, Vl: torch.Tensor) -> torch.Tensor:
    """The FMA as one library call (``torch.einsum``): the yardstick."""
    n_chunks = _check(Xg, Vl)
    return torch.einsum("tjpw,tjpk->tpwk", Vl.view(n_chunks, NB, SL, 8),
                        Xg.view(n_chunks, NB, SL, K)).reshape(-1, K)


def row_gather(X: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Part (a): ``X[rows]`` (``index_select``; the TPU probe's XLA row
    gather is no Pallas kernel)."""
    return X.index_select(0, rows)


def run(device, inp: Spmm4Inputs | None = None) -> dict:
    """Time (a) the row gather and (b) the FMA kernel beside its library
    call on the CUDA ``device`` (on ``inp``, already there, or on
    ``inputs()``); returns their times (ms) and bytes."""
    if inp is None:
        inp = inputs().to(device)
    Xg, Vl = inp.Xg, inp.Vl
    t_gather = paired_ms([lambda: row_gather(inp.X, inp.rows)], device, iters=10)[0]
    t_fma, t_lib = paired_ms([lambda: fma(Xg, Vl), lambda: fma_library(Xg, Vl)],
                             device, iters=10)
    return {"gather_ms": t_gather, "gather_bytes": 2 * N_ROWS * K * 4,
            "fma_ms": t_fma, "library_ms": t_lib,
            "fma_bytes": 2 * Xg.numel() * 4 + Vl.numel() * 4,
            "fma_flops": 2 * Vl.numel() * K}


def print_record(r, device) -> None:
    print(report("(a) row gather X[rows] (index_select)", r["gather_ms"], device,
                 r["gather_bytes"]), flush=True)
    print(report("(b) FMA kernel", r["fma_ms"], device, r["fma_bytes"],
                 r["fma_flops"], note=f"library (torch.einsum) "
                 f"{r['library_ms'] * 1e3:.2f} us"), flush=True)


def main() -> None:
    device = cuda_device()
    print(card(device), flush=True)
    warm_up(device)
    print_record(run(device), device)


if __name__ == "__main__":
    main()
