"""The collectives of the distributed paths, and a launcher for a world of ranks.

Counterpart of what ``jax.shard_map`` and XLA did for ``vbcs_tpu/parallel/``:
the replicated ``x`` (an all-gather of the ranks' x tiles), the halo's
``lax.all_to_all``, ``lax.psum`` and the assembly of ``y`` from the
ranks' disjoint column slices (``out_specs=P('d')`` there; here one
all-gather padded to the widest slice, then a cut of each rank's part,
or the stack itself for a caller that permutes it).  Each takes an
optional process ``group`` (default: the world).

The backend is the caller's choice (:func:`run_ranks`'s ``backend``):
NCCL on the card, gloo on the CPU, or gloo with CUDA tensors for a world
of several ranks on one card, which NCCL refuses ("Duplicate GPU
detected").  This module hands every collective the tensors as they lie
and stages none through host memory itself: gloo takes CUDA tensors for
all three collectives used here, and copies them through host memory
inside each (:data:`HOST_COPIES`), which is why its collectives take
milliseconds on a card; NCCL moves them on the card.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["HOST_COPIES", "world", "all_gather", "all_to_all", "all_reduce",
           "all_gather_x", "gather_stack", "gather_y", "run_ranks"]

# per backend, the collectives of this module whose CUDA tensors the
# backend itself copies through host memory (this module copies none)
HOST_COPIES = {"gloo": ("all_gather", "all_to_all_single", "all_reduce"),
               "nccl": ()}


def world(group=None) -> tuple[int, int]:
    """(ranks in ``group``, this rank's place in it)."""
    return dist.get_world_size(group), dist.get_rank(group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` (equal shapes), in rank order."""
    size, _ = world(group)
    out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def all_to_all(out: torch.Tensor, send: torch.Tensor, group=None,
               async_op: bool = False):
    """``all_to_all_single`` in equal splits along dim 0: rank ``r``'s
    ``send[d * h:(d + 1) * h]`` lands in rank ``d``'s ``out[r * h:(r + 1) * h]``.
    Returns the work handle when ``async_op`` (its ``wait()`` orders later
    work on the current stream after the exchange)."""
    return dist.all_to_all_single(out, send, group=group, async_op=async_op)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (the JAX ``psum``); returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_x(x_own: torch.Tensor, m: int, group=None) -> torch.Tensor:
    """The whole ``x`` (``[m]``) from each rank's own tiles (``x_own``, of
    equal length on every rank, the last zero-padded past ``m``)."""
    return all_gather(x_own, group).reshape(-1)[:m]


def gather_stack(y_local: torch.Tensor, width: int, group=None) -> torch.Tensor:
    """Every rank's ``y_local`` (``[n_rank, ...]``, ``n_rank <= width``)
    zero-padded to ``width`` rows and stacked in rank order:
    ``[world * width, ...]``."""
    buf = y_local.new_zeros((width, *y_local.shape[1:]))
    buf[:y_local.shape[0]] = y_local
    return all_gather(buf, group).reshape(-1, *y_local.shape[1:])


def gather_y(y_local: torch.Tensor, sizes, group=None) -> torch.Tensor:
    """The whole ``y`` on every rank from the ranks' disjoint row slices in
    rank order: rank ``d``'s ``y_local`` has ``sizes[d]`` rows; one padded
    all-gather (:func:`gather_stack`), then each rank's rows cut out."""
    width = max(1, *sizes)
    stack = gather_stack(y_local, width, group)
    return torch.cat([stack[d * width:d * width + s] for d, s in enumerate(sizes)])


def _rank_main(rank, world_size, backend, device, store, out, fn, args):
    """One rank: join the world through the file store, run ``fn(rank,
    world_size, device, *args)``, and write its result (or the traceback)
    to ``out``."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, store=dist.FileStore(store, world_size),
                                rank=rank, world_size=world_size)
        try:
            result = fn(rank, world_size, device, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise SystemExit(1)


def _rank_devices(world_size: int, backend: str, device) -> list[torch.device]:
    device = torch.device(device)
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"CPU ranks need the gloo backend, not {backend}")
        return [device] * world_size
    if device.type != "cuda":
        raise ValueError(f"no distributed path for device {device}")
    if device.index is not None:
        devs = [device] * world_size
    else:
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("no CUDA card for the ranks")
        devs = [torch.device("cuda", r % count) for r in range(world_size)]
    if backend == "nccl" and len(set(devs)) < world_size:
        raise ValueError(f"NCCL refuses two ranks on one GPU: {world_size} "
                         f"ranks on {len(set(devs))} card(s); use gloo")
    return devs


def run_ranks(fn, world_size: int, backend: str, device, *args,
              timeout: float = 900.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` fresh
    processes (``spawn``) joined in one ``torch.distributed`` world of
    ``backend`` ("gloo" or "nccl") through a ``FileStore``, and return
    their results in rank order.

    ``device`` is "cpu" (gloo only), "cuda" (rank ``r`` on card ``r``
    modulo the cards) or one card such as "cuda:0" (every rank on it; gloo
    only, since NCCL refuses two ranks on one card).  ``fn`` and ``args``
    must pickle, so ``fn`` is a module-level function.  The CUDA kernels
    are built here, before the ranks start, so that ranks never compile.  Raises ``RuntimeError`` with the first failing
    rank's traceback (the other ranks are stopped), or when the world has
    not finished after ``timeout`` seconds."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    devs = _rank_devices(world_size, backend, device)
    if devs[0].type == "cuda":
        from ..ops import _lib
        _lib.build()
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vbcs_ranks.")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, backend, devs[r], os.path.join(tmp, "store"), outs[r],
        fn, args)) for r in range(world_size)]

    def outcome(r):
        with open(outs[r], "rb") as f:
            return pickle.load(f)

    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.02)
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0):
                msg = outcome(r)[1] if os.path.exists(outs[r]) else ""
                raise RuntimeError(f"rank {r} of {world_size} ({backend}, "
                                   f"{devs[r]}) failed (exit {p.exitcode}):\n{msg}")
        if any(p.exitcode is None for p in procs):
            raise RuntimeError(f"the {world_size} ranks did not finish in "
                               f"{timeout:.0f} s")
        return [outcome(r)[1] for r in range(world_size)]
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
