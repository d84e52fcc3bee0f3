"""Static gather: ``out[i] = mask[i] ? src[perm[i]] : 0`` (f32).

Port of ``vbcs_tpu/ops/windowed_gather.py`` (``apply_permute``,
``apply_clos``; Pallas kernels ``_permute_kernel`` and ``_clos_kernel``)
and ``vbcs_tpu/ops/multipass.py`` (``apply_multipass``).  Those need a
pack-time routing plan; here the map itself is the plan.  On a CUDA
tensor :func:`gather` launches ``csrc/gather.cu``; on a CPU tensor it
runs :func:`gather_plain`.

``perm`` must lie in ``[0, src.numel())`` wherever the mask is set.
The kernel does not check that on the card (it would cost a device
sync); callers validate on the host, as ``VBCOperator`` does.

:func:`gather_tiles` is the same function on a map of whole ``TILE``-
element tiles (the halo tiles of ``parallel/stream.py``): one int32 a
tile, and a tile copy on the card that moves 16 bytes a thread.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["gather", "gather_plain", "gather_tiles", "gather_tiles_plain", "TILE"]

TILE = 1024  # elements of a tile of gather_tiles (csrc/gather.cu: kTileVec * 4)


def gather_plain(src: torch.Tensor, perm: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch gather: ``src[perm]``, zero where ``mask`` is False."""
    if mask is None:
        return src[perm]
    return torch.where(mask, src[torch.where(mask, perm, 0)], 0.0)


def gather(src: torch.Tensor, perm: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """``out[i] = src[perm[i]]`` (``0`` where ``mask[i]`` is False),
    shape ``perm.shape``.  ``src`` f32, ``perm`` int32, ``mask`` bool,
    all 1-D, contiguous and on one device."""
    dev = src.device
    if src.dtype != torch.float32:
        raise TypeError(f"src must be float32, got {src.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"perm must be int32, got {perm.dtype}")
    if src.dim() != 1 or perm.dim() != 1:
        raise ValueError("src and perm must be 1-D")
    if perm.numel() > torch.iinfo(torch.int32).max:
        raise ValueError("perm is too long for int32 indexing")
    if perm.device != dev:
        raise ValueError(f"perm is on {perm.device}, src on {dev}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != perm.shape
                             or mask.device != dev):
        raise ValueError("mask must be a bool tensor shaped like perm, "
                         "on src's device")
    if not (src.is_contiguous() and perm.is_contiguous()
            and (mask is None or mask.is_contiguous())):
        raise ValueError("src, perm and mask must be contiguous")
    if dev.type == "cpu":
        return gather_plain(src, perm, mask)
    if dev.type != "cuda":
        raise NotImplementedError(f"no gather kernel for device {dev}")
    out = torch.empty(perm.numel(), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _lib.launch(gather, "vbcs_gather", dev, out.numel(), src.data_ptr(), perm.data_ptr(),
                _lib.ptr(mask), out.data_ptr())
    return out


gather.launches = 0


def gather_tiles_plain(src: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch tile copy: ``src``'s ``TILE``-element tiles ``tiles``,
    one after another."""
    return src.view(-1, TILE)[tiles].reshape(-1)


def gather_tiles(src: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """``out[t * TILE + i] = src[tiles[t] * TILE + i]``, shape
    ``[tiles.numel() * TILE]``.  ``src`` f32, 1-D, a whole number of
    tiles long, ``tiles`` int32 in ``[0, src.numel() // TILE)`` (unchecked
    on the card, as for :func:`gather`), both contiguous on one device;
    on the card ``src`` starts on 16 bytes."""
    dev = src.device
    if src.dtype != torch.float32:
        raise TypeError(f"src must be float32, got {src.dtype}")
    if tiles.dtype != torch.int32:
        raise TypeError(f"tiles must be int32, got {tiles.dtype}")
    if src.dim() != 1 or tiles.dim() != 1 or src.numel() % TILE:
        raise ValueError(f"src must be 1-D and a multiple of {TILE} long, "
                         f"tiles 1-D")
    if tiles.device != dev:
        raise ValueError(f"tiles is on {tiles.device}, src on {dev}")
    if not (src.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("src and tiles must be contiguous")
    if tiles.numel() * TILE > torch.iinfo(torch.int32).max:
        raise ValueError("too many tiles for int32 indexing")
    if dev.type == "cpu":
        return gather_tiles_plain(src, tiles)
    if dev.type != "cuda":
        raise NotImplementedError(f"no gather_tiles kernel for device {dev}")
    if src.data_ptr() % 16:
        raise ValueError("src must start on 16 bytes (the kernel's float4 loads)")
    out = torch.empty(tiles.numel() * TILE, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _lib.launch(gather_tiles, "vbcs_gather_tiles", dev, tiles.numel(), src.data_ptr(),
                tiles.data_ptr(), out.data_ptr())
    return out


gather_tiles.launches = 0
