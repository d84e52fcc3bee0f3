"""ctypes bindings for the C++ host fast paths (built with g++ on first use).

Port of ``vbcs_tpu/native/__init__.py``.  The C++ source is the port's
own ``vbc_native.cpp`` beside this file, a verbatim copy of the JAX
package's, so the planner stays bitwise the same while the port builds
and reads nothing of the JAX package.  It is compiled into ``build/`` at
the repository root.  The bindings keep the JAX package's signatures;
the port needs the DP planner, the 1D-VBC packer and the overlap
chunker.

Set ``VBCS_NO_NATIVE=1`` to force the pure-NumPy implementations, which
stay the bitwise oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

__all__ = [
    "build",
    "get_lib",
    "dp_partition_native",
    "pack_1dvbc_native",
    "overlap_chunk_native",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vbc_native.cpp")
# -ffp-contract=off: each product and sum rounded apart, as in the NumPy
# oracle and the device DP (g++ would contract the DP's ``stripe += a *
# beta`` into an FMA under -march=native, which flips ties on fractional
# cost tables)
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
         "-std=c++17")
# the flags are part of the library's name: a build under other flags is
# never loaded in its place
SO = os.path.join(_ROOT, "build", "libvbcnative-" + hashlib.sha256(
    " ".join(FLAGS).encode()).hexdigest()[:12] + ".so")
_lock = threading.Lock()
_lib = None
_failed = False


def build() -> float:
    """Compile ``SRC`` with ``FLAGS`` into ``SO`` if it is missing or older
    than the source; returns the seconds spent (0.0 when up to date).  Raises
    ``OSError`` or ``subprocess.CalledProcessError`` when g++ fails."""
    if os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC):
        return 0.0
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    # a private output name, then an atomic rename: test workers that
    # build at the same time never load a half-written library
    tmp = f"{SO}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    if os.environ.get("VBCS_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            build()
            lib = ctypes.CDLL(SO)
        except (OSError, subprocess.SubprocessError):
            _failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.dp_partition.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, f64p, f64p, f64p, f64p,
            f64p, i64p, i64p,
        ]
        lib.dp_partition.restype = None
        lib.pack_1dvbc_count.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, i64p, i64p, i64p,
        ]
        lib.pack_1dvbc_count.restype = None
        lib.pack_1dvbc_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p,
            ctypes.c_int64, i64p, i64p, i64p, i64p, f64p,
        ]
        lib.pack_1dvbc_fill.restype = None
        lib.overlap_chunk.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_double, ctypes.c_int64,
            i64p, i64p,
        ]
        lib.overlap_chunk.restype = None
        _lib = lib
        return _lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dp_partition_native(
    n, num_groups, pos, grp, W, alpha_tab, beta_tabs, gamma_tab, weights,
    delta_tab=None,
):
    """Run the native DP; returns split points or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    grp = np.ascontiguousarray(grp, dtype=np.int64)
    alpha_tab = np.ascontiguousarray(alpha_tab, dtype=np.float64)
    beta_tabs = np.ascontiguousarray(beta_tabs, dtype=np.float64)
    R = beta_tabs.shape[0] if beta_tabs.ndim == 2 else 1
    beta_flat = beta_tabs.reshape(-1)
    g = (
        np.ascontiguousarray(gamma_tab, dtype=np.float64)
        if gamma_tab is not None
        else None
    )
    wts = (
        np.ascontiguousarray(weights, dtype=np.float64).reshape(-1)
        if weights is not None
        else None
    )
    d = (
        np.ascontiguousarray(delta_tab, dtype=np.float64)
        if delta_tab is not None
        else None
    )
    out_spl = np.zeros(n + 2, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    lib.dp_partition(
        int(n),
        int(max(num_groups, 1)),
        _p64(pos),
        _p64(grp),
        int(W),
        int(R),
        _pf64(alpha_tab),
        _pf64(beta_flat),
        _pf64(g),
        _pf64(wts),
        _pf64(d),
        _p64(out_spl),
        _p64(out_len),
    )
    return out_spl[: int(out_len[0])]


def pack_1dvbc_native(m, n, pos, idx, val, spl):
    """Native two-pass CSC->1D-VBC (float64 values); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    val64 = np.ascontiguousarray(val, dtype=np.float64)
    spl = np.ascontiguousarray(spl, dtype=np.int64)
    L = spl.size - 1
    bpos = np.zeros(L + 1, dtype=np.int64)
    bofs = np.zeros(L + 1, dtype=np.int64)
    lib.pack_1dvbc_count(
        int(m), int(n), _p64(pos), _p64(idx), int(L), _p64(spl),
        _p64(bpos), _p64(bofs),
    )
    out_idx = np.zeros(int(bpos[-1]), dtype=np.int64)
    out_val = np.zeros(int(bofs[-1]), dtype=np.float64)
    lib.pack_1dvbc_fill(
        int(m), int(n), _p64(pos), _p64(idx), _pf64(val64), int(L),
        _p64(spl), _p64(bpos), _p64(bofs), _p64(out_idx), _pf64(out_val),
    )
    return bpos, out_idx, bofs, out_val


def overlap_chunk_native(n, pos, idx, rho, w_max):
    """Native greedy overlap chunker; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out_spl = np.zeros(n + 2, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    lib.overlap_chunk(
        int(n), _p64(pos), _p64(idx), float(rho), int(w_max),
        _p64(out_spl), _p64(out_len),
    )
    return out_spl[: int(out_len[0])]
