"""Tile relayout: natural ``x [m]`` -> the ``(8, R*128)`` tile-interleaved
buffer, zero-padded past ``m``.

Port of ``vbcs_tpu/ops/pallas_trspmv3.py``'s ``_tile_relayout_call`` (a
Pallas kernel over ``Rb`` blocks of 8,192 elements; here ``R = 8*Rb``
counts blocks of 1,024), the layout ``entry3`` builds for its ``"tile"``
entry mode: ``out[s, r*128 + l] = x[r*1024 + s*128 + l]``.  No path of
either package calls it; the port's kernels read natural x directly.  On
a CUDA tensor :func:`tile_relayout` launches ``csrc/relayout.cu``; on a
CPU tensor it runs :func:`tile_relayout_plain`.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["tile_relayout", "tile_relayout_plain"]


def _check(x: torch.Tensor, R: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    if R < 1 or x.numel() > R * 1024:
        raise ValueError(f"need R >= 1 and x.numel() <= R * 1024, got R={R}, "
                         f"x.numel()={x.numel()}")
    if R * 1024 > torch.iinfo(torch.int32).max:
        raise ValueError(f"R={R} is too large for int32 indexing")


def tile_relayout_plain(x: torch.Tensor, R: int) -> torch.Tensor:
    """Plain PyTorch relayout: pad, view ``(R, 8, 128)``, swap the first
    two axes."""
    _check(x, R)
    xp = torch.zeros(R * 1024, dtype=torch.float32, device=x.device)
    xp[: x.numel()] = x
    return xp.view(R, 8, 128).transpose(0, 1).reshape(8, R * 128)


def tile_relayout(x: torch.Tensor, R: int) -> torch.Tensor:
    """The ``(8, R*128)`` tile-interleaved buffer of ``x`` (f32, 1-D,
    ``x.numel() <= R*1024``).

    CUDA tensors run the relayout kernel (or raise); CPU tensors run
    :func:`tile_relayout_plain`."""
    _check(x, R)
    dev = x.device
    if dev.type == "cpu":
        return tile_relayout_plain(x, R)
    if dev.type != "cuda":
        raise NotImplementedError(f"no relayout kernel for device {dev}")
    out = torch.empty(8, R * 128, dtype=torch.float32, device=dev)
    _lib.launch(tile_relayout, "vbcs_tile_relayout", dev, x.numel(), R, x.data_ptr(),
                out.data_ptr())
    return out


tile_relayout.launches = 0
