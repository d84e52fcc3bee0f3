"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source under ``vbcs_tpu_torch/csrc`` for
``sm_90a`` (one process per source, all started together) and links the
objects into one shared library with a plain C interface, in ``build/``
at the repository root, on first use; ctypes loads it.  Each launcher
takes device pointers and a CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()``.  Every kernel wrapper of ``ops/`` and
``probes/`` launches through :func:`launch`.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from ..utils import trace

__all__ = ["build", "load", "check", "launch", "ptr"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SO = os.path.join(os.path.dirname(_PKG), "build", "libvbcs_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_TIMEOUT = 600  # seconds for each nvcc process
_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise if one fails, kill the rest."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{out}")
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "".join(logs)


def build() -> tuple[float, str]:
    """Compile the kernels if the library is missing or older than a
    source.  Returns (seconds spent, compiler output); raises
    ``RuntimeError`` when nvcc is missing or fails."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    if os.path.exists(SO) and os.path.getmtime(SO) >= max(
            os.path.getmtime(s) for s in sources + headers):
        return 0.0, ""
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{SO}.{os.getpid()}.tmp"
    objdir = tempfile.mkdtemp(prefix="kernels.", dir=os.path.dirname(SO))
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(objdir, os.path.basename(s) + ".o") for s in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                        for s, o in zip(sources, objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        os.replace(tmp, SO)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0, log


def load():
    """The kernel library, built on first use (raises if it cannot be);
    the lock is taken only until it has loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with trace.span("lib.load"):
                build()
                lib = ctypes.CDLL(SO)
                vp, i32, u32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_uint32, ctypes.c_int64,
                                          ctypes.c_float)
                lib.vbcs_tr_spmv.argtypes = [i32] * 3 + [vp] * 9 + [f32, f32, vp, vp]
                lib.vbcs_tr_spmv.restype = i32
                lib.vbcs_tr_spmv_f64.argtypes = [i32] * 3 + [vp] * 9 + [
                    ctypes.c_double, ctypes.c_double, vp, vp]
                lib.vbcs_tr_spmv_f64.restype = i32
                lib.vbcs_tr_spmv_2d.argtypes = [i32, i32] + [vp] * 7 + [f32, f32, vp, vp]
                lib.vbcs_tr_spmv_2d.restype = i32
                lib.vbcs_tr_spmm.argtypes = [i32, i64, i32, i32, i64, i32, i32] + [vp] * 10
                lib.vbcs_tr_spmm.restype = i32
                lib.vbcs_ordered_products.argtypes = [i32, i64, i32, i32, i32] + [
                    vp] * 9 + [f32, f32, vp, vp, vp]
                lib.vbcs_ordered_products.restype = i32
                lib.vbcs_ordered_rows.argtypes = [i32, i64, vp, vp, vp, vp, f32, f32, vp, vp]
                lib.vbcs_ordered_rows.restype = i32
                lib.vbcs_gather.argtypes = [i32, vp, vp, vp, vp, vp]
                lib.vbcs_gather.restype = i32
                lib.vbcs_gather_tiles.argtypes = [i32, vp, vp, vp, vp]
                lib.vbcs_gather_tiles.restype = i32
                lib.vbcs_tr_spmv_scatter.argtypes = [i32, i32] + [vp] * 9 + [
                    f32, f32, vp, vp]
                lib.vbcs_tr_spmv_scatter.restype = i32
                lib.vbcs_tr_spmv_chain.argtypes = [i32, i32] + [vp] * 8 + [
                    f32, vp, vp, vp, vp, vp, vp, u32, i32, i32, vp]
                lib.vbcs_tr_spmv_chain.restype = i32
                lib.vbcs_chain_grid.argtypes = [ctypes.POINTER(i32)] * 2
                lib.vbcs_chain_grid.restype = i32
                lib.vbcs_tile_relayout.argtypes = [i32, i32, vp, vp, vp]
                lib.vbcs_tile_relayout.restype = i32
                # the split-point DP (ops/dp.py)
                lib.vbcs_dp_table.argtypes = [i64, i32, i32, i64] + [vp] * 9
                lib.vbcs_dp_table.restype = i32
                lib.vbcs_dp_table_scratch_doubles.argtypes = [i64, i32, i32]
                lib.vbcs_dp_table_scratch_doubles.restype = i64
                lib.vbcs_dp_recurrence.argtypes = [i64, i32] + [vp] * 4
                lib.vbcs_dp_recurrence.restype = i32
                lib.vbcs_dp_scan_scratch_doubles.argtypes = [i64, i32]
                lib.vbcs_dp_scan_scratch_doubles.restype = i64
                lib.vbcs_dp_scan.argtypes = [i64, i32] + [vp] * 5
                lib.vbcs_dp_scan.restype = i32
                lib.vbcs_dp_recurrence_checked.argtypes = [i64, i32, i32, i32] + [vp] * 6
                lib.vbcs_dp_recurrence_checked.restype = i32
                lib.vbcs_dp_chain_floor.argtypes = [i64] + [vp] * 3
                lib.vbcs_dp_chain_floor.restype = i32
                # the probes (vbcs_tpu_torch/probes)
                lib.vbcs_probe_add_one.argtypes = [i32, vp, vp, vp]
                lib.vbcs_probe_add_one.restype = i32
                lib.vbcs_probe_chunk.argtypes = [i32] * 4 + [vp] * 7
                lib.vbcs_probe_chunk.restype = i32
                lib.vbcs_probe_chain_grid.argtypes = [i32] + [ctypes.POINTER(i32)] * 2
                lib.vbcs_probe_chain_grid.restype = i32
                lib.vbcs_probe_chain.argtypes = [i32] * 4 + [vp] * 8 + [u32, i32, i32, vp]
                lib.vbcs_probe_chain.restype = i32
                lib.vbcs_probe_spmm4_fma.argtypes = [i32] + [vp] * 4
                lib.vbcs_probe_spmm4_fma.restype = i32
                lib.vbcs_error_string.argtypes = [i32]
                lib.vbcs_error_string.restype = ctypes.c_char_p
                _lib = lib
        return _lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib.vbcs_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> int | None:
    """A tensor's device pointer as a launcher takes it: None (a null
    pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def launch(kernel, entry: str, device, *args, name: str | None = None) -> None:
    """Call the library's ``entry`` on the CUDA ``device``, inside its
    context: with ``args`` (ints, floats and device pointers, :func:`ptr`)
    followed by the device's current stream.  Raises ``RuntimeError``
    naming the launch (``name``, else ``kernel.__name__``) when the entry
    reports a CUDA error, else counts it in ``kernel.launches``.
    ``kernel`` None is a host query of the device (an occupancy grid),
    which takes no stream and is not counted."""
    lib = _lib if _lib is not None else load()
    with torch.cuda.device(device):
        if kernel is None:
            rc = getattr(lib, entry)(*args)
        else:
            rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, name or kernel.__name__)
    if kernel is not None:
        kernel.launches += 1
