"""The chain probe (``vbcs_tpu_torch/probes/probe_chain.py``) against the
Pallas kernel of ``bench_tools/probe_chain.py``.

A recorder in place of the TPU probe's ``run_variant`` captures the four
variants of ``main()``; each then runs through the probe's own
``run_variant`` at ``T = 2`` chunks (``X = 2 * NS`` slot lanes) with
``pallas_call`` in interpret mode and a ``periter`` that only builds the
grid-``(n_iters, T)`` calls for the chain lengths under test.  The port's
chain wrapper runs its plain version on the same inputs; the persistent
CUDA kernel is held against that on the card in ``test_torch_cuda.py``.

Tolerance: ``|Δ| / max|ref| <= 2e-5`` (f32 sums in another order,
carried through the chain; values grow by ~2.8 an iteration, so the
chains are short).  The kernel runs with 64-bit types off, as on the TPU:
its ``lax.rem(program_id, 2)`` needs the literal to be int32.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_tools import probe_chain as jpc  # noqa: E402
from vbcs_tpu_torch.probes import probe_chain as tpc  # noqa: E402

T = 2
TOL = 2e-5
ITERS = (1, 3)  # one iteration, and both slots in turn


def recorded():
    rec = []
    orig = jpc.run_variant
    jpc.run_variant = lambda name, body, **k: rec.append((name, body, k))
    try:
        jpc.main()
    finally:
        jpc.run_variant = orig
    return rec


@pytest.fixture(scope="module")
def bodies():
    return {name: (body, k) for name, body, k in recorded()}


def test_every_tpu_variant_has_a_port():
    rec = recorded()
    assert [r[0] for r in rec] == [v[0] for v in tpc.VARIANTS]
    assert [r[2].get("wblk", 2) for r in rec] == [v[2] for v in tpc.VARIANTS]


@pytest.mark.parametrize("name, variant, wblk", tpc.VARIANTS)
def test_variant_matches_pallas(name, variant, wblk, bodies, monkeypatch):
    body, k = bodies[name]
    monkeypatch.setattr(jpc, "T", T)
    monkeypatch.setattr(jpc, "X", T * jpc.NS)
    calls = []
    orig = pl.pallas_call

    def patched(*a, **kk):
        kk["interpret"] = True
        kk.pop("compiler_params", None)
        calls.append(orig(*a, **kk))
        return calls[-1]

    def periter(mk, *a, **kk):
        for n in ITERS:
            mk(n)
        return 1.0

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jpc, "periter", periter)
    inp = tpc.inputs(T, wblk)
    with jax.enable_x64(False):
        jpc.run_variant(name, body, **k)
        assert len(calls) == len(ITERS)
        args = [jnp.asarray(t.numpy())
                for t in (inp.wbase, inp.val, inp.meta, inp.xin)]
        wants = [np.asarray(call(*args)) for call in calls]
    for n, want in zip(ITERS, wants):
        got = tpc.chain(variant, inp, n).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (8, T * 1024)
        assert np.isfinite(want).all()
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL, (n, variant)


def test_carry_adds_the_last_lane_of_the_chunk_before():
    inp = tpc.inputs(3)
    b = tpc.chain_plain("B", inp, 1)
    d = tpc.chain_plain("D", inp, 1)
    lanes0 = torch.arange(3) * 1024
    assert torch.equal(d[:, 0], b[:, 0])  # chunk 0 adds nothing
    assert torch.equal(d[:, lanes0[1:]], b[:, lanes0[1:]] + b[:, lanes0[1:] - 1])
    rest = torch.ones(3 * 1024, dtype=torch.bool)
    rest[lanes0] = False
    assert torch.equal(d[:, rest], b[:, rest])


def test_refusals():
    inp = tpc.inputs(1)
    with pytest.raises(ValueError, match="unknown"):
        tpc.chain("E", inp, 1)
    with pytest.raises(ValueError, match="n_iters"):
        tpc.chain("B", inp, 0)
    with pytest.raises(ValueError, match="n_iters"):
        tpc.chain("B", inp, 2**31)
    with pytest.raises(ValueError, match="meta"):
        tpc.chain("B", inp._replace(meta=inp.meta.long()), 1)
    with pytest.raises(ValueError, match="wbase"):
        tpc.chain("B", inp._replace(wbase=inp.wbase[:3]), 1)


@pytest.mark.parametrize("variant, wblk", [("B", 2), ("C", 1)])
def test_library_matrix_is_one_iteration(variant, wblk):
    """``library_matrix``, the matrix ``chip_smoke.py`` times
    ``torch.addmv`` on beside the chain kernel's marginal iteration,
    applies one iteration of the full body to x (f32 sums in another
    order: TOL); ``A`` and ``D`` are no such product."""
    inp = tpc.inputs(3, wblk)
    M = tpc.library_matrix(variant, inp)
    assert M.shape == (8 * 3 * 1024, 8 * 3 * 1024)
    z = torch.zeros(M.shape[0])
    got = torch.addmv(z, M, inp.xin.reshape(-1), beta=0.0, alpha=0.999)
    want = tpc.chain_plain(variant, inp, 1).reshape(-1)
    assert (got - want).abs().max() <= TOL * want.abs().max()
    for other in ("A", "D"):
        with pytest.raises(ValueError):
            tpc.library_matrix(other, inp)


# ---- the kernel's maps (csrc/probe_chain.cu), walked in NumPy

F32 = np.float32
OPTIN = 232448  # an H100's largest shared-memory budget a block
NS = tpc.NS
WBLK = dict((v, w) for _, v, w in tpc.VARIANTS)


def kernel_cu():
    path = os.path.join(os.path.dirname(__file__), "..", "vbcs_tpu_torch", "csrc",
                        "probe_chain.cu")
    with open(path) as fh:
        return fh.read()


def test_bytes_are_the_kernels():
    import re
    src = kernel_cu()
    got = {}
    for name in ("kColBytes", "kWinBytes"):
        m = re.search(rf"constexpr int {name} = 4 \* \((\d+) \+ (\d+)\);", src)
        assert m is not None, name
        got[name] = 4 * sum(int(g) for g in m.groups())
    assert (tpc.COL_BYTES, tpc.WIN_BYTES) == (got["kColBytes"], got["kWinBytes"]) \
        == (288, 516)


@pytest.mark.parametrize("blocks", [1, 7, 132, 264])
@pytest.mark.parametrize("T", [1, 2, 5, 40])
@pytest.mark.parametrize("budget", [OPTIN, 64 * 288 + 16 * 516 + 100, 0])
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_plan_covers_each_column_once(variant, T, blocks, budget):
    X = T * NS
    wblk = WBLK[variant]
    U, K = tpc.units(variant, wblk)
    p = tpc.plan(X, blocks, budget, variant, wblk)
    n = np.diff(p.lo)
    assert p.lo[0] == 0 and p.lo[-1] == X and (n >= 0).all()
    assert n.max() - n.min() <= 1  # balanced to within one column
    owner = np.repeat(np.arange(blocks), n)  # each column exactly once
    assert owner.size == X and (np.bincount(owner, minlength=blocks) == n).all()
    c0 = p.lo[:-1]
    at_start = (c0 % NS == 0) & (c0 > 0)
    assert (p.halo == ((variant == "D") & at_start & (p.resident > 0))).all()
    assert (p.resident >= 0).all() and (p.spill >= 0).all()
    assert (p.resident + p.spill == n).all()
    first = c0 - p.halo  # the windows of the units from the halo's to the last resident's
    last = c0 + p.resident - 1
    assert (p.windows == np.where(p.resident > 0, (last // U - first // U + 1) * K, 0)).all()
    assert (p.bytes == (p.resident + p.halo) * tpc.COL_BYTES
            + p.windows * tpc.WIN_BYTES).all()
    assert (p.bytes <= budget).all()
    # a block streams columns only where one more would not fit
    more = tpc.plan(X, blocks, budget + 2 * tpc.COL_BYTES + 2 * K * tpc.WIN_BYTES,
                    variant, wblk)
    assert ((p.spill == 0) | (more.resident > p.resident)).all()
    if budget == OPTIN and T == 40 and blocks >= 132:
        assert (p.spill == 0).all()  # ~100-120 KB a block


def test_plan_refusals():
    for args in ((1024, 0, 0), (1024, 1, -1), (-1, 1, 0)):
        with pytest.raises(ValueError):
            tpc.plan(*args, "B", 2)


def decode(inp, s, c):
    """``decode``: column ``c``'s gather ``s`` (B, C, D) as ``(pos,
    window)``: its slot offset (-1 where dropped) and its window ``row
    wblk + d`` within the slice."""
    meta, wbase, X = inp.meta.numpy(), inp.wbase.numpy(), inp.meta.shape[1]
    q = c // 128
    m = meta[s, c].astype(np.int64) & 0xFFFFFFFF
    lo = m & 127
    d = np.zeros_like(m) if inp.wblk == 1 else (m >> 7) & 3
    keep = d < inp.wblk
    dc = np.minimum(d, inp.wblk - 1)  # the kernel reads nothing where dropped
    at = meta[s, q * 128 + lo].astype(np.int64) & 0xFFFFFFFF
    row = (at >> (16 + 3 * dc)) & 7
    return (np.where(keep, row * X + wbase[q * inp.wblk + dc] + lo, -1),
            row * inp.wblk + dc)


def positions(variant, inp, c):
    """``position<V>``: ``[8, len(c)]`` slot offsets, -1 where dropped (A:
    the window lane of each row)."""
    X, wbase = inp.meta.shape[1], inp.wbase.numpy()
    if variant == "A":
        return np.stack([s * X + wbase[c // NS * tpc.NV * 2] + c % 128 for s in range(8)])
    return np.stack([decode(inp, s, c)[0] for s in range(8)])


def local_positions(variant, inp, c, u0):
    """``local_position<V>``: ``[8, len(c)]`` offsets into the staged
    windows from unit ``u0``, -1 where dropped."""
    if variant == "A":
        return np.stack([((c // NS - u0) * 8 + s) * 128 + c % 128 for s in range(8)])
    out = []
    for s in range(8):
        pos, window = decode(inp, s, c)
        out.append(np.where(pos < 0, -1, ((c // 128 - u0) * 8 * inp.wblk + window) * 128
                            + pos % 128))
    return np.stack(out)


def window_starts(variant, inp, u0, nwin):
    """``window_start<V>`` of the staged windows ``0 .. nwin - 1``."""
    X, wbase = inp.meta.shape[1], inp.wbase.numpy()
    U, K = tpc.units(variant, inp.wblk)
    e = np.arange(nwin)
    u, k = u0 + e // K, e % K
    if variant == "A":
        return k * X + wbase[u * tpc.NV * 2]
    return (k // inp.wblk) * X + wbase[u * inp.wblk + k % inp.wblk]


def fma(a, b, c):
    """``fmaf`` in f32: the product exact in f64, one add rounded to f32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(F32)


def sums(variant, vals, g, ws):
    """``sums<V, kW>``: rows ``ws`` of columns with values ``vals [64,
    k]`` and gathered x ``g [8, k]``: B-D unscaled, A with ``+ g[w] * 0``."""
    res = []
    for w in ws:
        acc = np.zeros(vals.shape[1], F32)
        for s in range(8):
            acc = ((acc + vals[8 * w + s]).astype(F32) if variant == "A"
                   else fma(vals[8 * w + s], g[s], acc))
        res.append(acc + g[w] * F32(0) if variant == "A" else acc)
    return np.stack(res).astype(F32)


def scaled(variant, acc):
    return acc if variant == "A" else (acc * F32(0.999)).astype(F32)


def walk(variant, inp, n_iters, blocks, budget):
    """The kernel's launch: each block's prologue (its resident columns'
    values, their positions in its staged windows, the halo last; the
    windows' starts), then per iteration the windows' copy, the multiply
    items (column, half) with D's pair rule, and its streamed columns a
    column at a time.  Every output must be written exactly once an
    iteration."""
    val, X = inp.val.numpy(), inp.val.shape[1]
    U, K = tpc.units(variant, inp.wblk)
    p = tpc.plan(X, blocks, budget, variant, inp.wblk)
    D = variant == "D"
    x = inp.xin.numpy()
    for _ in range(n_iters):
        dst = np.full((8, X), np.nan, F32)
        writes = np.zeros((8, X), np.int64)

        def store(ws, c, r):
            dst[np.ix_(ws, c)] = r
            writes[np.ix_(ws, c)] += 1

        xf = x.reshape(-1)
        for b in range(blocks):
            c0, c1, nr, h = int(p.lo[b]), int(p.lo[b + 1]), int(p.resident[b]), bool(p.halo[b])
            cols = np.r_[np.arange(c0, c0 + nr), [c0 - 1] if h else []].astype(np.int64)
            u0 = (c0 - h) // U if nr else 0
            lp = local_positions(variant, inp, cols, u0)  # the prologue
            start = window_starts(variant, inp, u0, int(p.windows[b]))
            sval = val[:, cols]
            win = xf[start[:, None] + np.arange(128)].reshape(-1)  # the windows
            g = np.where(lp >= 0, win[np.maximum(lp, 0)] if win.size else 0, F32(0))
            j = np.arange(nr)
            c = c0 + j
            skip = D & (c % NS == NS - 1) & (c + 1 < c1)
            carry = D & (c % NS == 0) & (c > 0)
            jp = np.where(j == 0, nr, j - 1)[carry]
            for hh in (0, 1):  # the multiply
                ws = list(range(4 * hh, 4 * hh + 4))
                res = scaled(variant, sums(variant, sval[:, :nr], g[:, :nr], ws))
                if carry.any():
                    prev = sums(variant, sval[:, jp], g[:, jp], ws)
                    own = j[carry] > 0
                    store(ws, c[carry][own] - 1, scaled(variant, prev[:, own]))
                    res[:, carry] = fma(prev, 0.999, res[:, carry])
                store(ws, c[~skip], res[:, ~skip])
            cs = np.arange(c0 + nr, c1)  # streamed columns
            if cs.size == 0:
                continue

            def column(cc):
                pc = positions(variant, inp, cc)
                return sums(variant, val[:, cc],
                            np.where(pc >= 0, xf[np.maximum(pc, 0)], F32(0)), range(8))
            skip = D & (cs % NS == NS - 1) & (cs + 1 < c1)
            carry = D & (cs % NS == 0) & (cs > 0)
            res = scaled(variant, column(cs))
            if carry.any():
                prev = column(cs[carry] - 1)
                own = cs[carry] - 1 >= c0
                store(range(8), cs[carry][own] - 1, scaled(variant, prev[:, own]))
                res[:, carry] = fma(prev, 0.999, res[:, carry])
            store(range(8), cs[~skip], res[:, ~skip])
        assert (writes == 1).all(), "an output written other than once"
        x = dst
    return x


# (T, blocks, budget): all resident; halos where ranges start at chunk
# starts (D); a spilled chunk start and its column before; the resident
# parts ending at a chunk's last column (256 columns and two slices' windows
# fit 95,000 bytes, 257 and three do not); a block starting at a chunk
# start with nothing resident (no halo: the column before from global
# memory); everything streamed; more blocks than the full grid
WALKS = [(5, 7, OPTIN), (3, 6, OPTIN), (2, 1, 60000), (3, 4, 95000), (2, 2, 0),
         (1, 264, OPTIN)]


@pytest.mark.parametrize("T, blocks, budget", WALKS)
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_walk_matches_plain(variant, T, blocks, budget):
    inp = tpc.inputs(T, WBLK[variant])
    p = tpc.plan(T * NS, blocks, budget, variant, inp.wblk)
    if (T, blocks) == (3, 6):
        assert p.halo.sum() == (2 if variant == "D" else 0)  # ranges from 1024, 2048
    if (T, blocks) in ((2, 1), (3, 4)):
        assert (p.spill > 0).any() and (p.resident > 0).all()
    for n in (1, 2, 3):
        want = tpc.chain_plain(variant, inp, n).numpy()
        got = walk(variant, inp, n, blocks, budget)
        assert np.isfinite(want).all()
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL, (variant, n)


def test_walk_crosses_every_boundary():
    """The walk's plans meet each case the kernel's D pair rule handles: a
    resident chunk start whose column before is the halo, or resident; a
    streamed chunk start whose column before is streamed, or resident (the
    resident part ending at a chunk's last column); a block starting at a
    chunk start with nothing resident."""
    seen = set()
    for T, blocks, budget in WALKS:
        p = tpc.plan(T * NS, blocks, budget, "D", 2)
        for b in range(blocks):
            c0, c1, nr = int(p.lo[b]), int(p.lo[b + 1]), int(p.resident[b])
            for c in range(c0 + (c0 == 0), c1):
                if c % NS:
                    continue
                if c < c0 + nr:
                    seen.add("resident, halo" if c == c0 else "resident, resident")
                elif c == c0:
                    seen.add("streamed, nothing resident")
                else:
                    seen.add("streamed, " + ("resident" if c - 1 < c0 + nr else "streamed"))
    assert seen == {"resident, halo", "resident, resident", "streamed, streamed",
                    "streamed, resident", "streamed, nothing resident"}


@pytest.mark.parametrize("wblk", [1, 2])
def test_decoded_positions_are_the_gathers(wblk):
    """The kernel's decode equals ``_gather`` (``pos`` where ``keep``, -1
    elsewhere), on metadata with windows past ``wblk`` (dropped) too; each
    position in the staged windows names the same slot offset; A's are the
    plain step's window lanes."""
    T = 3
    inp = tpc.inputs(T, wblk)
    meta = inp.meta.clone()
    rng = np.random.default_rng(5)
    hit = torch.from_numpy(rng.random(meta.shape) < 0.1)
    meta[hit] = (meta[hit] & ~(3 << 7)) | (int(rng.integers(2, 4)) << 7)
    inp = inp._replace(meta=meta)
    c = np.arange(T * NS)
    pos, keep = tpc._gather(inp)
    got = positions("B", inp, c)
    assert (~keep).any() == (wblk == 2)
    assert np.array_equal(got, np.where(keep.numpy(), pos.numpy(), -1))
    variants = ("A", "B") if wblk == 2 else ("C",)
    for variant in variants:
        U, K = tpc.units(variant, wblk)
        for c0, c1 in ((0, T * NS), (1000, 1300), (2047, 2049)):
            cc = np.arange(c0, c1)
            u0 = c0 // U
            start = window_starts(variant, inp, u0, ((c1 - 1) // U - u0 + 1) * K)
            lp = local_positions(variant, inp, cc, u0)
            slot = positions(variant, inp, cc)
            assert ((lp < 0) == (slot < 0)).all()
            assert np.array_equal(np.where(lp < 0, -1, start[lp // 128] + lp % 128), slot)
    if wblk == 2:
        lane = inp.wbase.numpy()[(c // NS) * tpc.NV * 2] + c % 128
        assert np.array_equal(positions("A", inp, c),
                              np.arange(8)[:, None] * T * NS + lane[None])


def test_chain_refuses_a_grid_or_budget_below_zero():
    inp = tpc.inputs(1)
    with pytest.raises(ValueError, match="blocks"):
        tpc.chain("B", inp, 1, blocks=0)
    with pytest.raises(ValueError, match="budget"):
        tpc.chain("B", inp, 1, budget=-1)
    with pytest.raises(ValueError, match="wbase"):  # A reads wbase[t * 16]
        tpc.chain("A", tpc.inputs(2, 1), 1)
