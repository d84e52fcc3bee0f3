"""Probe 2: the v3 kernel's design pieces on the card.

Port of ``bench_tools/probe_kernel2.py``: the same eight variants on the
same chunk shape (``T = 39`` chunks of ``NG = 1024`` columns) and inputs
(``numpy.random.default_rng(0)``, int32 or int16 metadata, an x of 2,504
or 8,192 rows, the window bases ``wbase``), through the chunk kernel
(``probes/chunk.py``, ``csrc/probe_chunk.cu``): the floor, the window
sums, the exact two-take gather, the full v3 body at int32 and int16
metadata, one window a slice and a 4 MB x, and the roll.  Each is timed
warm and with L2 flushed beside its bound.

Run on the card:  python -m vbcs_tpu_torch.probes.probe_kernel2
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import card, cuda_device, warm_up
from .chunk import NG, W, ChunkInputs, print_records, time_variants

__all__ = ["inputs", "VARIANTS", "run", "main"]

T = 39
NV = NG // 128
# the TPU probe's variants, in its order -> (the chunk kernel's variant,
# the inputs' settings)
VARIANTS = [
    ("a floor (val+meta int32, x vmem)", "stream", {}),
    ("b 16 dyn window slices from x", "winsum", {}),
    ("c 2-take exact gather wblk=2", "take2", {}),
    ("d FULL v3 (2take gthr+prod+red)", "take2_red", {}),
    ("d16 FULL v3, int16 metadata", "take2_red", {"meta_dtype": np.int16}),
    ("dw1 FULL v3 wblk=1", "take2_red", {"wblk": 1}),
    ("e pltpu.roll(+7) sublane", "roll_add", {}),
    ("f v3 with 4MB x in VMEM", "take2_red", {"xrows": 8192}),
]


def inputs(T: int = T, meta_dtype=np.int32, wblk: int = 2,
           xrows: int = 2504) -> ChunkInputs:
    """The TPU probe's inputs (``run_variant``), on the CPU: val, loA in
    ``[0, 128)``, hiA in ``[0, 8)``, x of ``xrows`` rows and the window
    bases wbase (multiples of 8)."""
    rng = np.random.default_rng(0)
    val = rng.standard_normal((8 * W, T * NG)).astype(np.float32)
    loA = rng.integers(0, 128, (8, T * NG)).astype(meta_dtype)
    hiA = rng.integers(0, 8, (8, T * NG)).astype(meta_dtype)
    x2d = rng.standard_normal((xrows, 128)).astype(np.float32)
    wbase = (rng.integers(0, (xrows - 8) // 8, (T * NV * wblk,)) * 8).astype(np.int32)
    return ChunkInputs(*(torch.from_numpy(a) for a in (val, loA, hiA, x2d, wbase)),
                       wblk)


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
