"""Autotuned execution-time cost model for the DP planner, on a CUDA card.

Port of ``vbcs_tpu/models/autotune.py`` (the reference's headline
capability, ``src/costs.jl:12-136``): time the shipped TrSpMV route on
synthetic width-uniform matrices, fit per-width costs by relative-error
least squares, and hand the tables to the optimal DP as a
:class:`~vbcs_tpu_torch.models.cost.ColumnBlockComponentCostModel` (1-D)
or a rank-R :class:`~vbcs_tpu_torch.models.cost.BlockComponentCostModel`
(2-D).  The synthetic families, their seeds and sizes, the design
matrices, the clipping, the 2-D monotonization, interpolation and SVD
are the JAX package's, so an injected ``measure=`` law gives its tables.

What differs:

* the timed kernel is this port's route, the one ``tr_mul`` runs
  (``operator.route_tr_spmv`` / ``route_tr_spmv_2d``), timed with CUDA
  events (``utils/timing.paired_ms``) as a chain of calls, each reading
  the previous output: ``y = call(fmt, x, 1, 0.5, y)``, the reference's
  ``mul!(y, A', x, alpha, beta)`` (``bin/test_table.jl:80``), one launch a
  call.  A reading below the card's own bound for the call's bytes
  (``utils/profile.roofline``) is retried and then dropped;
* the cache key holds a fingerprint of the card (its name, compute
  capability, CUDA and PyTorch versions) in place of the JAX device
  kind, and the cache lives under ``$VBCS_CACHE/vbcs_tpu_torch/autotune``
  (default ``~/.cache/vbcs_tpu_torch/autotune``), never the JAX package's;
* the 1-D fit still returns the JAX package's ``(alpha, beta, gamma)``
  triple, gamma charged per excess 8-block group ``E`` (a feature of
  the TPU stream kernel), but :func:`model_1dvbc_trspmv_time` builds its
  model from ``alpha`` and ``beta``: the port's model has no gamma term
  (:func:`fit_1d` compares the fit with and without it).

Without ``measure=`` the functions time on the card and raise on a CPU
device: a host clock is no device metric.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .cost import BlockComponentCostModel, ColumnBlockComponentCostModel

__all__ = [
    "model_1dvbc_trspmv_time",
    "autotune_1dvbc_trspmv",
    "model_vbc_trspmv_time",
    "autotune_vbc_trspmv",
    "cache_dir",
    "cache_path_1d",
    "cache_path_2d",
    "fit_1d",
]

CHAIN_BETA = 0.5  # y = call(fmt, x, 1, CHAIN_BETA, y): bounded, one launch a call
# The 2-D fit builds its synthetics on this many host threads (NumPy and
# scipy release the GIL in the sorts and conversions that dominate), all
# before the first is timed, so no build competes with the timed launches.
HOST_THREADS = min(8, os.cpu_count() or 1)


def cache_dir() -> str:
    """The autotune cache directory (read from the environment each call)."""
    root = os.environ.get("VBCS_CACHE", os.path.expanduser("~/.cache"))
    return os.path.join(root, "vbcs_tpu_torch", "autotune")


def _arch_id(device) -> str:
    """Fingerprint of the card (reference ``arch_id()``: SHA of cpuinfo):
    its name and compute capability, and the CUDA and PyTorch versions;
    ``cpu`` and the PyTorch version for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        device = _card(device)
        cap = torch.cuda.get_device_capability(device)
        key = (f"cuda|{torch.cuda.get_device_name(device)}|sm_{cap[0]}{cap[1]}|"
               f"{torch.version.cuda}|{torch.__version__}")
    else:
        key = f"{device.type}|{torch.__version__}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _cache_path(key: dict) -> str:
    return os.path.join(cache_dir(), hashlib.sha256(
        json.dumps(key).encode()).hexdigest()[:24] + ".json")


def cache_path_1d(W=8, d=8, target_bytes=64 << 20, band=400, *, device) -> str:
    """Where :func:`autotune_1dvbc_trspmv` caches these arguments' tables
    (and the samples they were fit to, under ``"data"``)."""
    return _cache_path(dict(W=W, d=d, tb=target_bytes, band=band,
                            arch=_arch_id(device), v=7))


def cache_path_2d(U=4, W=8, d=8, target_bytes=64 << 20, band=400,
                  subsample=True, *, device) -> str:
    """Where :func:`autotune_vbc_trspmv` caches these arguments' tables."""
    return _cache_path(dict(U=U, W=W, d=d, tb=target_bytes, band=band,
                            arch=_arch_id(device), sub=bool(subsample), v=4))


def _card(device) -> torch.device:
    """``device`` as a CUDA device that exists; raises otherwise (the
    measurement never times on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the autotuner times the kernels on a CUDA card, "
                           f"not on {device}; pass measure= to fit injected times")
    return device


def _synth(L, w, d, band, seed):
    """Width-uniform banded blocky matrix (reference src/costs.jl:63-82
    plus banding for x locality)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m = L * w
    cs = np.arange(L) * w + w // 2
    rr = np.clip(cs[:, None] + rng.integers(-band, band, (L, d)), 0, m - 1)
    rows = np.repeat(rr.reshape(-1), w)
    cols = (
        np.repeat(np.arange(L) * w, d)[:, None] + np.arange(w)[None, :]
    ).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsc()
    A.sum_duplicates()
    return A


def _synth_fem(k):
    """5-point grid Laplacian in natural band order (what auto-RCM
    recovers from a scrambled FEM matrix): rows scatter across +-k, so
    wider stripes hold more distinct rows."""
    import scipy.sparse as sp

    n = k * k
    main = np.full(n, 4.0)
    off = -np.ones(n - 1)
    offk = -np.ones(n - k)
    return sp.diags(
        [main, off, off, offk, offk], [0, 1, -1, k, -k], format="csc"
    ).astype(np.float32)


def _chain_s(call, fmt, device, nbytes):
    """Seconds a call of ``call(fmt, x, 1, CHAIN_BETA, y)``, each call
    reading the previous one's y, from CUDA events; None when every try
    reads below the card's bound for ``nbytes`` (an implausible reading,
    retried with longer chains as the JAX package retries)."""
    from ..utils.profile import roofline
    from ..utils.timing import paired_ms

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(fmt.m).astype(np.float32)).to(device)
    y = [torch.zeros(fmt.n, dtype=torch.float32, device=device)]

    def step():
        y[0] = call(fmt, x, 1.0, CHAIN_BETA, y[0])

    floor = roofline(int(nbytes), device=device).ideal_s
    t = paired_ms([step], device)[0] * 1e-3
    tries = 0
    while t < floor and tries < 3:
        t = paired_ms([step], device, iters=200)[0] * 1e-3
        tries += 1
    return t if t >= floor else None


def _call_bytes(fmt) -> int:
    """Bytes a routed call must move: its format's arrays, x, y in and out."""
    from ..utils.profile import stream_bytes

    return stream_bytes(fmt) + 4 * fmt.n


def _measure_shipped(B, device):
    """Seconds a call of the TrSpMV ``VBCOperator.tr_mul`` routes for the
    f32 pack ``B`` (``operator.route_tr_spmv``: the scatter kernel or the
    stripe kernel), and the route's name; ``(None, name)`` when the
    reading stays implausible."""
    from ..operator import route_tr_spmv

    device = _card(device)
    kname, fmt, call = route_tr_spmv(B, device)
    return _chain_s(call, fmt, device, _call_bytes(fmt)), kname


def _measure_shipped_2d(B2, device):
    """Seconds a call of the TrSpMV ``VBC2DOperator.tr_mul`` routes for
    the f32 2-D pack ``B2`` (``operator.route_tr_spmv_2d``: the tile
    kernel, or the stripe kernel on the 1-D view, as
    ``operator.tile2d_worthwhile`` decides), and the route's name.  The
    chain runs through y, so rectangular synthetics chain as square ones
    do."""
    from ..operator import route_tr_spmv_2d

    device = _card(device)
    kname, fmt, call = route_tr_spmv_2d(B2, device)
    return _chain_s(call, fmt, device, _call_bytes(fmt)), kname


def fit_1d(data: dict, W: int, with_E: bool = True, with_const: bool = False):
    """The 1-D relative-error least squares over the samples ``data``
    (``Ls, ws, qs, Gs, ts`` as the cache keeps them): the JAX package's
    one-hot design ``[L e_w | q e_w | E e_w]`` (reference
    ``src/costs.jl:112-122`` plus the per-group TPU term), without the E
    block when ``with_E`` is False and with a per-call constant column
    when ``with_const``.  Returns ``(alpha, beta, gamma, const, resid)``
    before clipping (gamma zeros without E, const 0.0 without it) and the
    root-mean-square relative residual of the samples."""
    Ls, ws, qs, Gs = (np.asarray(data[k]) for k in ("Ls", "ws", "qs", "Gs"))
    T = np.asarray(data["ts"], dtype=np.float64)
    N = T.size
    blocks = 3 if with_E else 2
    D = np.zeros((N, blocks * W + int(with_const)))
    for i in range(N):
        D[i, ws[i] - 1] = Ls[i]
        D[i, W + ws[i] - 1] = qs[i]
        if with_E:
            D[i, 2 * W + ws[i] - 1] = Gs[i]
    if with_const:
        D[:, -1] = 1.0
    Dr = D / T[:, None]
    sol, *_ = np.linalg.lstsq(Dr, np.ones(N), rcond=None)
    resid = float(np.sqrt(np.mean((Dr @ sol - 1.0) ** 2))) if N else 0.0
    gamma = sol[2 * W:3 * W].copy() if with_E else np.zeros(W)
    const = float(sol[-1]) if with_const else 0.0
    return sol[:W].copy(), sol[W:2 * W].copy(), gamma, const, resid


def autotune_1dvbc_trspmv(
    W: int = 8,
    d: int = 8,
    target_bytes: int = 64 << 20,
    band: int = 400,
    verbose: bool = False,
    cache: bool = True,
    measure=None,
    require_cache: bool = False,
    *,
    device,
):
    """Measure + fit; returns the ``(alpha_col[W], beta_col[W],
    gamma_col[W])`` tables in ns, gamma per excess 8-block group.

    ``require_cache=True`` raises ``FileNotFoundError`` instead of timing
    when no cached tables exist.  ``measure(B, w) -> seconds | None``
    replaces the timing on the card (tests fit injected laws on the CPU);
    without it ``device`` must be a CUDA card.

    The JAX package's two families feed the fit: banded blocky (d full
    blocks a stripe near the diagonal, three sizes a width) and, when
    timing for real, the FEM-like grid Laplacian equi-partitioned at each
    width and a banded family of 2d + 1 blocks a stripe (so E is not
    collinear with L)."""
    path = cache_path_1d(W, d, target_bytes, band, device=device)
    if cache and os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
        return (np.asarray(data["alpha"]), np.asarray(data["beta"]),
                np.asarray(data["gamma"]))
    if require_cache:
        raise FileNotFoundError(
            f"no cached autotune tables for this device ({path})")
    if measure is None:
        device = _card(device)

    from ..formats.csc import CSC
    from ..formats.partition import SplitPartition
    from ..formats.vbc1d import pack_1dvbc

    ms, Ls, ws, qs, Gs, ts, kernels = [], [], [], [], [], [], []

    def add_sample(A, w):
        C = CSC.from_scipy(A)
        B = pack_1dvbc(C, SplitPartition.equi(C.n, w), W)
        if measure is not None:
            t, kname = measure(B, w), "injected"
        else:
            t, kname = _measure_shipped(B, device)
        if t is None:
            return  # drop this sample
        nb = (B.pos[1:] - B.pos[:-1]).astype(np.int64)
        ms.append(C.m)
        Ls.append(len(B.Phi))
        ws.append(w)
        qs.append(B.num_blocks)
        Gs.append(int(np.maximum(-(-nb // 8) - 1, 0).sum()))  # excess groups
        ts.append(t * 1e9)  # ns
        kernels.append(kname)
        if verbose:
            print(f"w={w} L={len(B.Phi)} q={B.num_blocks} E={Gs[-1]} "
                  f"t={t * 1e6:.2f}us ({B.num_blocks * w / t / 1e9:.1f} "
                  f"Gstored/s) [{kname}]")

    for w in range(W, 0, -1):
        # the JAX package's sizing: L such that its TPU stream ~ target_bytes
        bytes_per_block = 8 * w * 4 + 8 * 4 + 4
        L0 = max(2048, int(target_bytes / (d * bytes_per_block + 2 * w * 4)))
        for Lf, qf in [(1.0, 1.0), (0.5, 1.0), (1.0, 0.5)]:
            L = max(1024, int(L0 * Lf))
            dd = max(1, int(d * qf))
            add_sample(_synth(L, w, dd, band, seed=w * 7 + int(Lf * 2)), w)
        if measure is None:
            add_sample(_synth_fem(max(64, band // 2)), w)
            Lmg = max(1024, L0 // 3)
            add_sample(_synth(Lmg, w, 2 * d + 1, band, seed=w * 13), w)

    # relative-error LSQ on the one-hot design, no m column (square
    # synthetics make it collinear with L e_w); clipped at 0, not
    # monotonized, as in the JAX package
    data = dict(ms=ms, Ls=Ls, ws=ws, qs=qs, Gs=Gs, ts=ts, kernels=kernels)
    alpha, beta, gamma, _, _ = fit_1d(data, W)
    alpha = np.maximum(alpha, 0.0)
    beta = np.maximum(beta, 0.0)
    gamma = np.maximum(gamma, 0.0)
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"alpha": alpha.tolist(), "beta": beta.tolist(),
                       "gamma": gamma.tolist(), "data": data}, fh)
    return alpha, beta, gamma


def model_1dvbc_trspmv_time(W: int = 8, **kwargs) -> ColumnBlockComponentCostModel:
    """Autotuned time model for the DP (reference
    ``model_SparseMatrix1DVBC_TrSpMV_time``, ``src/costs.jl:12``): the
    fit's alpha and beta tables (the port's model has no gamma term)."""
    alpha, beta, _gamma = autotune_1dvbc_trspmv(W, **kwargs)
    return ColumnBlockComponentCostModel(alpha_col=alpha, beta_col=beta)


def _synth2d(K, u, L, w, d, band, seed):
    """(u, w)-uniform 2-D blocky matrix: K row blocks of height u, L
    column stripes of width w, ~d dense u x w tiles per stripe near the
    diagonal (reference ``src/costs.jl:195-222``, plus banding)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m, n = K * u, L * w
    cb = (np.arange(L) * w) // max(u, 1)  # diagonal row-block per stripe
    bb = max(1, band // max(u, 1))
    rb = np.clip(cb[:, None] + rng.integers(-bb, bb + 1, (L, d)), 0, K - 1)
    l_t = np.repeat(np.arange(L), d)
    k_t = rb.reshape(-1)
    rows = (k_t[:, None] * u + np.arange(u)[None, :]).reshape(-1)
    rows = np.repeat(rows, w)
    cols = np.broadcast_to(
        (l_t[:, None] * w + np.arange(w)[None, :])[:, None, :], (L * d, u, w)
    ).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def _sizes(n: int, subsample: bool) -> list:
    """The block sizes the 2-D fit measures: all of 1..n, or the powers of
    two and n."""
    if not subsample:
        return list(range(1, n + 1))
    s, k = set(), 1
    while k <= n:
        s.add(k)
        k *= 2
    s.add(n)
    return sorted(s)


def _synth2d_specs(U: int, W: int, d: int, target_bytes: int,
                   subsample: bool):
    """The 2-D fit's samples, in the order it measures them: ``(u, w, K,
    L, d, seed)`` of :func:`_synth2d` for each measured size pair, four
    synthetics each (L, the blocks a stripe and K varied apart so the
    design is full rank)."""
    for u in reversed(_sizes(U, subsample)):
        for w in reversed(_sizes(W, subsample)):
            bytes_per_tile = u * w * 4 + 8 + u * 8 * 4 / max(u, 1)
            L0 = max(2048, int(target_bytes / (d * bytes_per_tile + 2 * w * 4)))
            for Lf, qf, Kf in ((1.0, 1.0, 1.0), (0.5, 1.0, 1.0),
                               (1.0, 0.5, 1.0), (1.0, 1.0, 2.0)):
                L = max(1024, int(L0 * Lf))
                K = max(1, int((L * w) // u * Kf))
                dd = max(1, int(d * qf))
                yield u, w, K, L, dd, u * 31 + w * 7 + int(qf * 2) + int(Kf)


def _pack2d(spec, U: int, W: int, band: int):
    """``(u, w, B2)``: the synthetic of a :func:`_synth2d_specs` entry,
    packed at its uniform (u, w) partitions."""
    from ..formats.csc import CSC
    from ..formats.partition import SplitPartition
    from ..formats.vbc2d import pack_vbc2d

    u, w, K, L, d, seed = spec
    C = CSC.from_scipy(_synth2d(K, u, L, w, d, band, seed))
    return u, w, pack_vbc2d(C, SplitPartition.equi(C.m, u),
                            SplitPartition.equi(C.n, w), U, W)


def autotune_vbc_trspmv(
    U: int = 4,
    W: int = 8,
    d: int = 8,
    target_bytes: int = 64 << 20,
    band: int = 400,
    rank: int = 3,
    verbose: bool = False,
    cache: bool = True,
    measure=None,
    subsample: bool = True,
    *,
    device,
):
    """Measure + fit the 2-D time model (reference ``src/costs.jl:249-290``).

    Returns ``(alpha_row[U], alpha_col[W], beta_row, beta_col)``, the
    last two rank-``rank`` tuples of per-size tables from the SVD of the
    monotonized beta[u, w] grid.  The timed route is the one
    ``VBC2DOperator.tr_mul`` takes for each synthetic
    (``operator.route_tr_spmv_2d``).  ``subsample=True`` measures the
    powers of two (and U, W) and interpolates the rest, as the JAX
    package does.  ``measure(B2, u, w) -> seconds | None`` replaces the
    timing on the card."""
    path = cache_path_2d(U, W, d, target_bytes, band, subsample,
                         device=device)
    if cache and os.path.exists(path):
        with open(path) as fh:
            z = json.load(fh)
        return (np.asarray(z["alpha_row"]), np.asarray(z["alpha_col"]),
                tuple(np.asarray(t) for t in z["beta_row"]),
                tuple(np.asarray(t) for t in z["beta_col"]))
    if measure is None:
        device = _card(device)

    u_sizes, w_sizes = _sizes(U, subsample), _sizes(W, subsample)
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        packs = list(pool.map(lambda s: _pack2d(s, U, W, band), _synth2d_specs(
            U, W, d, target_bytes, subsample)))
    Ks, Ls, us, ws, qs, ts, kernels = [], [], [], [], [], [], []
    for u, w, B2 in packs:
        if measure is not None:
            t, kname = measure(B2, u, w), "injected"
        else:
            t, kname = _measure_shipped_2d(B2, device)
        if t is None:
            continue
        Ks.append(len(B2.Pi))
        Ls.append(len(B2.Phi))
        us.append(u)
        ws.append(w)
        qs.append(B2.num_blocks)
        ts.append(t * 1e9)
        kernels.append(kname)
        if verbose:
            print(f"u={u} w={w} L={len(B2.Phi)} q={B2.num_blocks} "
                  f"t={t * 1e6:.2f}us [{kname}]")

    # relative-error LSQ on [K e_u | L e_w | q e_{u,w}] (src/costs.jl:252-263)
    N = len(ts)
    nu, nw = len(u_sizes), len(w_sizes)
    upos = {u: i for i, u in enumerate(u_sizes)}
    wpos = {w: i for i, w in enumerate(w_sizes)}
    D = np.zeros((N, nu + nw + nu * nw))
    for i in range(N):
        D[i, upos[us[i]]] = Ks[i]
        D[i, nu + wpos[ws[i]]] = Ls[i]
        D[i, nu + nw + upos[us[i]] * nw + wpos[ws[i]]] = qs[i]
    T = np.asarray(ts)
    sol, *_ = np.linalg.lstsq(D / T[:, None], np.ones(N), rcond=None)
    alpha_row_s = np.maximum(sol[:nu], 0.0)
    alpha_col_s = np.maximum(sol[nu:nu + nw], 0.0)
    beta_s = np.maximum(sol[nu + nw:].reshape(nu, nw), 0.0)
    # the sampled sizes expanded to full 1..U / 1..W tables (linear interp)
    full_u = np.arange(1, U + 1, dtype=np.float64)
    full_w = np.arange(1, W + 1, dtype=np.float64)
    alpha_row = np.interp(full_u, u_sizes, alpha_row_s)
    alpha_col = np.interp(full_w, w_sizes, alpha_col_s)
    beta_w = np.stack([np.interp(full_w, w_sizes, r) for r in beta_s])
    beta = np.stack(
        [np.interp(full_u, u_sizes, beta_w[:, j]) for j in range(W)], axis=1)
    # monotonized along both axes (src/costs.jl:268-277)
    for uu in range(1, U):
        alpha_row[uu] = max(alpha_row[uu], alpha_row[uu - 1])
        beta[uu, :] = np.maximum(beta[uu, :], beta[uu - 1, :])
    for ww in range(1, W):
        alpha_col[ww] = max(alpha_col[ww], alpha_col[ww - 1])
        beta[:, ww] = np.maximum(beta[:, ww], beta[:, ww - 1])
    # rank-R SVD factorization so the DP stays separable (:279-284)
    Um, s, Vt = np.linalg.svd(beta, full_matrices=False)
    R = min(rank, s.size)
    beta_row = tuple(Um[:, r] * np.sqrt(s[r]) for r in range(R))
    beta_col = tuple(Vt[r, :] * np.sqrt(s[r]) for r in range(R))
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({
                "alpha_row": alpha_row.tolist(),
                "alpha_col": alpha_col.tolist(),
                "beta_row": [t_.tolist() for t_ in beta_row],
                "beta_col": [t_.tolist() for t_ in beta_col],
                "data": dict(Ks=Ks, Ls=Ls, us=us, ws=ws, qs=qs, ts=ts,
                             kernels=kernels),
            }, fh)
    return alpha_row, alpha_col, beta_row, beta_col


def model_vbc_trspmv_time(U: int = 4, W: int = 8, **kwargs) -> BlockComponentCostModel:
    """Autotuned 2-D time model (reference
    ``model_SparseMatrixVBC_TrSpMV_time``, ``src/costs.jl:144-290``)."""
    alpha_row, alpha_col, beta_row, beta_col = autotune_vbc_trspmv(U, W, **kwargs)
    return BlockComponentCostModel(alpha_row=alpha_row, alpha_col=alpha_col,
                                   beta_row=beta_row, beta_col=beta_col)
