"""Probe: the per-chunk cost of the TrSpMV kernel's components on the card.

Port of ``bench_tools/probe_kernel.py``: the same twelve variants on the
same flagship chunk shape (``val [64, NG]`` per chunk, ``NG = 1024``,
``T = 39`` chunks: 2,555,904 stored values), on inputs built from
``numpy.random.default_rng(0)`` as there, each through the chunk kernel
(``probes/chunk.py``, ``csrc/probe_chunk.cu``).  Where the TPU probe timed
a ``fori_loop`` of calls by the difference method, this one times the
launch with CUDA events, warm (back-to-back, the chunk L2-resident) and
with L2 flushed, and prints each beside the variant's bound.

Run on the card:  python -m vbcs_tpu_torch.probes.probe_kernel
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import card, cuda_device, warm_up
from .chunk import NG, W, ChunkInputs, print_records, time_variants

__all__ = ["inputs", "VARIANTS", "run", "main"]

T = 39  # flagship chunk count
NV = NG // 128
WBLK = 3  # x windows a 128-lane slice
# the TPU probe's variants, in its order -> (the chunk kernel's variant,
# the inputs' settings: all on the same inputs)
VARIANTS = [
    ("0 stream val only", "stream", {}),
    ("1 gather ladder wblk=3 (current)", "ladder", {}),
    ("2 sublane-aligned take x3 win", "sub3", {}),
    ("2b sublane-aligned take x1 win", "sub1", {}),
    ("2c sublane take + 1 roll (K=2)", "roll", {}),
    ("3 take_along_axis (8,1024) wide", "wide", {}),
    ("3b take_along_axis axis=0 sublane", "axis0", {}),
    ("4 current full (gthr+prod+red)", "ladder_red", {}),
    ("5 prod+red only (reshape-sum)", "const_red", {}),
    ("5b prod+red via MXU", "const_red", {}),
    ("5c prod+red strided slices", "const_red", {}),
    ("6 new full (subtake+MXU red)", "sub3_red", {}),
]


def inputs(T: int = T) -> ChunkInputs:
    """The TPU probe's inputs (``run_variant``), on the CPU: val, the row
    metadata in ``[0, 3 * 1024)``, x2d of ``8 * (T + 8)`` rows and the
    window table xtile."""
    rng = np.random.default_rng(0)
    val = rng.standard_normal((8 * W, T * NG)).astype(np.float32)
    row = rng.integers(0, WBLK * 1024, (8, T * NG)).astype(np.int32)
    x2d = rng.standard_normal((8 * (T + 8), 128)).astype(np.float32)
    xtile = rng.integers(0, T, (T * NV * WBLK,)).astype(np.int32)
    return ChunkInputs(torch.from_numpy(val), torch.from_numpy(row), None,
                       torch.from_numpy(x2d), torch.from_numpy(xtile), WBLK)


def run(device) -> list[dict]:
    """Time every variant on the CUDA ``device``, warm and with L2 flushed
    (``chunk.time_variants``: one record per TPU variant)."""
    return time_variants(device, VARIANTS, inputs)


def main() -> None:
    device = cuda_device()
    print(card(device), flush=True)
    warm_up(device)
    print_records(run(device), device)


if __name__ == "__main__":
    main()
