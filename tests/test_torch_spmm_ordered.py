"""The ordered scatter (``ops/ordered.py``, ``csrc/ordered.cu``) and the
choice of the pack the forward products run on (``operator.forward_pack``).

The CPU tests hold the plain version, its maps and the operator's choice
against ``A @ X`` in float64; the tests marked ``cuda`` hold the kernel
against the plain version on a card and skip without one.  The file
imports no JAX, so the card tests run with the port's dependencies alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_spmm_ordered.py

Tolerance ``|Δ| / max|Y| <= 2e-5``, the SpMM's: f32 sums in another order
than the float64 product's and the plain version's ``index_add_``.
"""

import collections
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.formats.device import ordered_maps, row_blocks
from vbcs_tpu_torch.formats.vbc1d import pack_1dvbc
from vbcs_tpu_torch.operator import forward_bytes, forward_pack
from vbcs_tpu_torch.plan.reorder import rcm_symmetric
from vbcs_tpu_torch.ops.ordered import (SECTOR_COLUMNS, launch_products, launch_rows,
                                        mul_ordered, mul_ordered_plain)
from vbcs_tpu_torch.utils import trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from spbench.gen import blocky, hpcg27  # noqa: E402

TOL = 2e-5


def rectangular():
    """600 x 900, 5 entries a column within 60 rows of its place, and a
    few rows with none."""
    rng = np.random.default_rng(17)
    m, n, d = 600, 900, 5
    c = (np.arange(n) * m) // n
    rows = np.clip(c[:, None] + rng.integers(-60, 60, (n, d)), 0, m - 1)
    rows[rows % 97 == 3] = 0  # rows 3, 100, ... left empty
    A = sp.coo_matrix((rng.standard_normal(n * d),
                       (rows.reshape(-1), np.repeat(np.arange(n), d))),
                      shape=(m, n)).tocsc().astype(np.float32)
    A.sum_duplicates()
    return A


def shaped_rows():
    """Rows with no block (0, 5), one block (1, 4) and many (2, 3, 6) in a
    10 x 12 matrix packed in stripes of 4 columns."""
    D = np.zeros((10, 12), dtype=np.float32)
    D[1, 0:2] = [1.5, -2.0]
    D[2, [0, 4, 5, 9]] = [3.0, 0.5, -1.0, 2.0]
    D[3, [1, 6, 11]] = [-0.25, 4.0, 1.0]
    D[4, 7] = 7.0
    D[6, :] = np.arange(12, dtype=np.float32) - 5.5
    D[7:, 3] = [1.0, 2.0, 3.0]
    return sp.csc_matrix(D)


# name -> the matrix; each runs the ordered scatter on a pack of A
MATRICES = {
    "blocky_300": lambda: blocky.generate(0, L=300),
    "hpcg_8": lambda: hpcg27.generate(0, nx=8, ny=8, nz=8),
    "rectangular": rectangular,
    "shaped_rows": shaped_rows,
}


def rel_err(got, want):
    got = got.double().cpu().numpy()
    return np.abs(got - want).max(initial=0.0) / max(1e-6, np.abs(want).max(initial=0.0))


def rhs(rows, k, seed):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(np.float32)


def on_a(A, device="cpu", W=8, method=None):
    """An operator whose forward products run on A's pack, whatever
    ``forward_pack`` would choose."""
    return vt.VBCOperator.from_host(vt.vbc1d(A, W, method), None, None, device,
                                    fw_on_a=True)


def relabeled(device="cpu"):
    """An operator on the pack of blocky's matrix under RCM, its forward
    products on that pack of A: the natural view's stripes read X through
    ``col_out``."""
    A = blocky.generate(3, L=300)
    Ap, perm = rcm_symmetric(vt.CSC.from_scipy(A))
    op = vt.VBCOperator.from_host(vt.vbc1d(Ap, 8), None, perm, device, fw_on_a=True)
    assert op.row_perm is not None and op.ordered_fw.col_out is not None
    return A, op


# ---- the plain version and its maps (CPU) ---------------------------------


@pytest.mark.parametrize("k", [1, 3, 32, 130])
@pytest.mark.parametrize("case", sorted(MATRICES) + ["relabeled"])
def test_mul_mat_on_a_matches_dense(case, k):
    if case == "relabeled":
        A, op = relabeled()
    else:
        A = MATRICES[case]()
        op = on_a(A)
    X = rhs(A.shape[1], k, seed=k)
    Y = op.mul_mat(torch.from_numpy(X))
    assert Y.shape == (A.shape[0], k)
    assert rel_err(Y, A.astype(np.float64) @ X) <= TOL
    assert torch.equal(Y, op.mul_mat(torch.from_numpy(X)))  # the same bits again


@pytest.mark.parametrize("case", sorted(MATRICES) + ["relabeled"])
def test_mul_alpha_beta_y_at_k1(case):
    if case == "relabeled":
        A, op = relabeled()
    else:
        A = MATRICES[case]()
        op = on_a(A)
    assert op.route_fw[0] == "ordered"
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    A64 = A.astype(np.float64)
    got = op.mul(torch.from_numpy(x), 0.5, 0.25, torch.from_numpy(y))
    assert got.shape == (A.shape[0],)
    assert rel_err(got, 0.5 * (A64 @ x) + 0.25 * y) <= TOL
    assert rel_err(op.mul(torch.from_numpy(x)), A64 @ x) <= TOL
    # beta without y, or y without beta, adds nothing (ops/trspmv.py's rule)
    assert torch.equal(op.mul(torch.from_numpy(x), 2.0, 0.25),
                       op.mul(torch.from_numpy(x), 2.0, None, torch.from_numpy(y)))


def maps_by_loop(idx, m):
    """The maps as their definition reads, one block at a time."""
    cnt = collections.Counter(idx)
    start, slot, row_ptr = {}, 0, []
    for r in range(m):
        start[r] = slot
        row_ptr.append(-slot - 1 if cnt[r] == 1 else slot)
        slot += cnt[r] if cnt[r] >= 2 else 0
    row_ptr.append(slot)
    seen, dest = collections.Counter(), []
    for r in idx:
        if cnt[r] == 1:
            dest.append(r)
        else:
            dest.append(-(start[r] + seen[r]) - 1)
            seen[r] += 1
    return dest, row_ptr, slot


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_ordered_maps_by_their_definition(case):
    A = MATRICES[case]()
    fmt = on_a(A).ordered_fw
    maps = fmt.ordered_maps
    dest, row_ptr, slots = maps_by_loop(fmt.idx.tolist(), fmt.m)
    assert maps.dest.dtype == maps.row_ptr.dtype == torch.int32
    assert maps.dest.tolist() == dest and maps.row_ptr.tolist() == row_ptr
    assert maps.slots == slots
    assert maps.rows_pass == any(c != 1 for c in np.bincount(fmt.idx.numpy(), minlength=fmt.m))
    assert maps.nbytes == 4 * (fmt.idx.numel() + fmt.m + 1)


def test_ordered_maps_rows_of_every_kind():
    """``shaped_rows`` has rows of no, one and several blocks; a row of
    one block is written by the products alone, the others by the rows
    pass."""
    fmt = on_a(shaped_rows(), W=4, method=vt.EquiChunker(4)).ordered_fw
    per_row = np.bincount(fmt.idx.numpy(), minlength=fmt.m)
    assert {0, 1} <= set(per_row.tolist()) and per_row.max() >= 3
    maps = fmt.ordered_maps
    rp = maps.row_ptr.numpy()
    assert np.array_equal(rp[:-1] < 0, per_row == 1)
    starts = np.where(rp >= 0, rp, -rp - 1)
    assert np.array_equal(np.diff(starts), np.where(per_row >= 2, per_row, 0))
    d = maps.dest.numpy()
    assert np.array_equal(d >= 0, per_row[fmt.idx.numpy()] == 1)
    assert sorted((-d[d < 0] - 1).tolist()) == list(range(maps.slots))


def test_ordered_maps_of_nothing():
    """A matrix with no entry: every row empty, no slot; an empty pack
    of no row: no map at all."""
    maps = ordered_maps(torch.zeros(0, dtype=torch.int32), 5)
    assert maps.dest.numel() == 0 and maps.row_ptr.tolist() == [0] * 6
    assert maps.slots == 0 and maps.rows_pass
    maps = ordered_maps(torch.zeros(0, dtype=torch.int32), 0)
    assert maps.row_ptr.tolist() == [0] and not maps.rows_pass
    op = on_a(sp.csc_matrix((7, 4), dtype=np.float32))
    assert torch.equal(op.mul_mat(torch.ones(4, 3)), torch.zeros(7, 3))


def _swapped_rows(fmt, X, monkeypatch, swap):
    """Y of the plain version before and after ``swap(maps, r0, r1,
    blocks)`` patches the maps of two blocks that are each their row's
    only one (rows r0, r1), and Y with those two rows swapped."""
    Y = mul_ordered_plain(fmt, X)
    maps = fmt.ordered_maps
    one = torch.nonzero(maps.dest >= 0).flatten()[:2]
    r0, r1 = maps.dest[one].tolist()
    swap(fmt, r0, r1, one)
    want = Y.clone()
    want[[r0, r1]] = Y[[r1, r0]]
    return mul_ordered_plain(fmt, X), want


def test_plain_goes_through_the_maps(monkeypatch):
    """From ``SECTOR_COLUMNS`` columns on, the plain version places the
    rows of one block and sums the slots of the others as the maps say: a
    ``dest`` that swaps the rows of two blocks, each its row's only one,
    swaps those rows of Y."""
    fmt = on_a(shaped_rows(), W=4, method=vt.EquiChunker(4)).ordered_fw

    def swap(fmt, r0, r1, one):
        maps = fmt.ordered_maps
        d = maps.dest.clone()
        d[one] = torch.tensor([r1, r0], dtype=torch.int32)
        monkeypatch.setitem(fmt.__dict__, "ordered_maps", maps._replace(dest=d))

    got, want = _swapped_rows(fmt, torch.from_numpy(rhs(12, SECTOR_COLUMNS, 0)),
                              monkeypatch, swap)
    assert torch.equal(got, want)


def test_plain_by_block_goes_through_row_blocks(monkeypatch):
    """Below ``SECTOR_COLUMNS`` columns the plain version sums every row's
    blocks through ``row_blocks``: swapping the blocks of two rows of one
    block each there swaps those rows of Y."""
    fmt = on_a(shaped_rows(), W=4, method=vt.EquiChunker(4)).ordered_fw

    def swap(fmt, r0, r1, one):
        rb = fmt.row_blocks
        b = rb.blocks.clone()
        i0, i1 = rb.start[r0].item(), rb.start[r1].item()
        b[[i0, i1]] = b[[i1, i0]]
        monkeypatch.setitem(fmt.__dict__, "row_blocks", rb._replace(blocks=b))

    got, want = _swapped_rows(fmt, torch.from_numpy(rhs(12, 3, 0)), monkeypatch, swap)
    assert torch.equal(got, want)


def test_wrapper_checks_its_operands():
    fmt = on_a(rectangular()).ordered_fw
    with pytest.raises(ValueError, match="shape"):
        mul_ordered(fmt, torch.zeros(fmt.m, 2))
    with pytest.raises(TypeError, match="float32"):
        mul_ordered(fmt, torch.zeros(fmt.n, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        mul_ordered(fmt, torch.zeros(2, fmt.n).t())
    with pytest.raises(ValueError, match="shape"):
        mul_ordered(fmt, torch.zeros(fmt.n, 2), 1.0, 0.5, torch.zeros(fmt.m, 3))
    assert mul_ordered(fmt, torch.zeros(fmt.n, 0)).shape == (fmt.m, 0)


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_row_blocks_by_their_definition(case):
    """The row -> blocks map of the launches by block: each row's blocks
    in block (stripe) order, one loop over the blocks."""
    fmt = on_a(MATRICES[case]()).ordered_fw
    idx = fmt.idx.tolist()
    rb = fmt.row_blocks
    assert rb.start.dtype == rb.blocks.dtype == torch.int32
    by_row = [[b for b, r in enumerate(idx) if r == row] for row in range(fmt.m)]
    assert rb.start.tolist() == np.cumsum([0] + [len(b) for b in by_row]).tolist()
    assert rb.blocks.tolist() == [b for blocks in by_row for b in blocks]
    assert rb.nbytes == 4 * (fmt.idx.numel() + fmt.m + 1)
    empty = row_blocks(torch.zeros(0, dtype=torch.int32), 3)
    assert empty.start.tolist() == [0] * 4 and empty.blocks.numel() == 0


def test_row_blocks_built_by_the_first_narrow_call():
    """A forward operator on A's pack holds the row -> blocks map only
    once a call below ``SECTOR_COLUMNS`` columns has run, and counts it
    in ``memory_bytes()`` from then on; a wide call builds nothing."""
    A = blocky.generate(0, L=300)
    op = on_a(A)
    held = op.memory_bytes()
    op.mul_mat(torch.ones(A.shape[1], SECTOR_COLUMNS))
    assert op.memory_bytes() == held and "row_blocks" not in op.ordered_fw.__dict__
    op.mul(torch.ones(A.shape[1]))
    assert op.memory_bytes() == held + op.ordered_fw.row_blocks.nbytes


# ---- the choice (CPU) ------------------------------------------------------


def test_forward_bytes_by_hand():
    """One stripe of two columns with blocks on rows 0 and 2 of a 3 x 2
    matrix, and its transpose's pack: the byte model's terms counted by
    hand, below ``SECTOR_COLUMNS`` (every block through its slot) and at
    it (only the blocks of a row of two or more)."""
    A = sp.csc_matrix(np.array([[1, 2], [0, 0], [3, 0]], dtype=np.float32))
    B = pack_1dvbc(vt.CSC.from_scipy(A), vt.SplitPartition(np.array([0, 2])), 2)
    Bt = vt.vbc1d(A.T.tocsc(), 1, vt.EquiChunker(1))
    assert B.num_blocks == 2 and B.memory_bytes() == 3 * 16 + 2 * 8 + 4 * 4
    # map (2 blocks, 3 rows + 1), a column: x (2), both blocks' slots twice, y (3)
    assert forward_bytes(B, "A") == B.memory_bytes() + 4 * (2 + 4) + 4 * (2 + 2 * 2 + 3)
    k = SECTOR_COLUMNS  # no row of two blocks: no slot
    assert forward_bytes(B, "A", k) == B.memory_bytes() + 4 * (2 + 4) + 4 * k * (2 + 3)
    # x a block (3 blocks of A.T), y (3), a column
    assert Bt.num_blocks == 3
    assert forward_bytes(Bt, "A.T") == Bt.memory_bytes() + 4 * (3 + 3)
    assert forward_bytes(Bt, "A.T", 5) == Bt.memory_bytes() + 4 * 5 * (3 + 3)
    C = pack_1dvbc(vt.CSC.from_scipy(A), vt.SplitPartition(np.array([0, 1, 2])), 1)
    assert C.num_blocks == 3  # row 0 in both stripes: 2 partials
    assert forward_bytes(C, "A") == C.memory_bytes() + 4 * (3 + 4) + 4 * (2 + 2 * 3 + 3)
    assert forward_bytes(C, "A", k) == C.memory_bytes() + 4 * (3 + 4) + 4 * k * (
        2 + 2 * 2 + 3)
    with pytest.raises(ValueError):
        forward_bytes(B, "AT")


class _Pack:
    """What the byte model reads of a pack: its stored bytes, blocks,
    shape and block rows."""

    def __init__(self, stored, m, n, idx):
        self.stored, self.m, self.n = stored, m, n
        self.idx = np.asarray(idx)
        self.num_blocks = self.idx.size

    def memory_bytes(self):
        return self.stored


@pytest.mark.parametrize("stored_a, blocks_at, want", [
    (100, 40, "A"),     # fewer bytes for a vector and a column of a wide X
    (100, 5, "A.T"),    # a vector's only: A.T's column is cheaper
    (10_000, 40, "A.T"),  # a wide X's only: A's stored bytes weigh on a vector
])
def test_forward_pack_needs_both_widths(stored_a, blocks_at, want):
    """A's pack: 8 blocks on 8 distinct rows of 8 (no slot at k >= 8);
    A.T's: 1,000 stored bytes and ``blocks_at`` blocks.  A vector moves
    A: stored + 4 (8 + 9) + 4 (8 + 16 + 8), A.T: 1,000 + 4 (blocks + 8);
    a column of a wide X A: 4 (8 + 8), A.T: 4 (blocks + 8)."""
    a = _Pack(stored_a, 8, 8, range(8))
    at = _Pack(1000, 8, 8, range(blocks_at))
    assert forward_pack(a, at) == want


def _spans(fn):
    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, [s["name"] for s in trace.snapshot()["spans"]]


def test_blocky_forward_takes_a_and_holds_only_it():
    A = blocky.generate(0, L=300)
    before = trace.forward_choices()
    op, names = _spans(lambda: vt.VBCOperator.from_csc(A, W=8, directions="forward",
                                                       reorder="never", device="cpu"))
    assert trace.forward_choices() == {**before, "A": before["A"] + 1}
    assert op.fw_on_a and op.host_fw is None and op.dev_fw is None
    assert op.route_fw[0] == "ordered"
    assert forward_pack(op.host_tr, vt.vbc1d(A.T.tocsc(), 8)) == "A"
    # A.T's candidate and A's planned and packed, one planner for both
    assert names.count("plan.dp") == names.count("plan.pack") == 2
    # under auto-RCM, each formulation's two labellings: RCM computed once
    _, names = _spans(lambda: vt.VBCOperator.from_csc(A, W=8, directions="forward",
                                                      device="cpu"))
    assert names.count("plan.rcm") == 1
    assert names.count("plan.dp") == names.count("plan.pack") == 4
    assert op.memory_bytes() == op.host_tr.memory_bytes() + 4 * (
        op.host_tr.num_blocks + A.shape[0] + 1)
    with pytest.raises(ValueError, match="transposed"):
        op.tr_mul(torch.zeros(A.shape[0]))
    with pytest.raises(ValueError, match="transposed"):
        op.tr_mul_mat(torch.zeros(A.shape[0], 2))
    with pytest.raises(ValueError, match="transposed"):
        op.tr_mul_chain(torch.zeros(A.shape[0]), 2)


def test_hpcg_forward_plans_once_and_keeps_at():
    """HPCG's matrix equals its transpose: one pack planned and packed
    for both formulations, and the gather kept, as before the choice."""
    A = hpcg27.generate(0, nx=8, ny=8, nz=8)
    assert (abs(A - A.T) > 0).nnz == 0
    before = trace.forward_choices()
    op, names = _spans(lambda: vt.VBCOperator.from_csc(A, W=8, directions="forward",
                                                       device="cpu"))
    assert trace.forward_choices() == {**before, "A.T": before["A.T"] + 1}
    assert not op.fw_on_a and op.host_tr is None and op.route_fw[0] != "ordered"
    assert names.count("plan.dp") == names.count("plan.pack") == 1
    want = vt.vbc1d(A.T.tocsc(), 8)
    assert np.array_equal(op.host_fw.idx, want.idx)
    assert np.array_equal(op.host_fw.val, want.val)


def test_f64_forward_keeps_at_unweighed():
    A = blocky.generate(0, L=300, dtype="float64")
    before = trace.forward_choices()
    op, names = _spans(lambda: vt.VBCOperator.from_csc(A, W=8, directions="forward",
                                                       reorder="never", device="cpu"))
    assert trace.forward_choices() == before
    assert not op.fw_on_a and op.host_tr is None and op.host_fw.val.dtype == np.float64
    assert names.count("plan.dp") == names.count("plan.pack") == 1
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    assert np.allclose(op.mul(torch.from_numpy(x)).numpy(), A @ x, rtol=1e-12)


def test_transposed_still_refuses_the_forward_products():
    A = blocky.generate(0, L=300)
    before = trace.forward_choices()
    op = vt.VBCOperator.from_csc(A, W=8, directions="transposed", device="cpu")
    assert trace.forward_choices() == before and not op.fw_on_a
    with pytest.raises(ValueError, match="forward"):
        op.mul_mat(torch.zeros(A.shape[1], 2))
    with pytest.raises(ValueError, match="forward"):
        op.mul(torch.zeros(A.shape[1]))


def test_both_picks_from_what_it_holds():
    """A "both" operator plans its two packs as before and runs
    ``mul_mat`` on A's where the choice says so; ``mul`` keeps the route
    of A.T's pack (and a float64 x its semiring route), ``tr_mul`` A's
    pack."""
    A = blocky.generate(0, L=300)
    before = trace.forward_choices()
    op, names = _spans(lambda: vt.VBCOperator.from_csc(A, W=8, directions="both",
                                                       reorder="never", device="cpu"))
    assert trace.forward_choices() == {**before, "A": before["A"] + 1}
    assert names.count("plan.dp") == names.count("plan.pack") == 2
    assert op.fw_on_a and op.host_fw is not None and op.nat_tr is op.ordered_fw
    want = vt.route_tr_spmv(op.host_fw, op.device, op.nat_fw, None)
    assert op.route_fw[0] == want[0] != "ordered" and op.route_fw[2] is want[2]
    A64 = A.astype(np.float64)
    X = rhs(A.shape[1], 4, 1)
    assert rel_err(op.mul_mat(torch.from_numpy(X)), A64 @ X) <= TOL
    x = X[:, 0].astype(np.float64)
    semi = trace.semiring_calls()
    got = op.mul(torch.from_numpy(x))
    assert trace.semiring_calls() == {**semi, "float64": semi.get("float64", 0) + 1}
    assert np.allclose(got.numpy(), A64 @ x, rtol=1e-12, atol=1e-12)
    assert op.semi_fw.m == A.shape[1] and op.semi_fw.row.numel() == op.host_fw.val.size
    assert rel_err(op.mul(torch.from_numpy(X[:, 1].copy())), A64 @ X[:, 1]) <= TOL
    xt = rhs(A.shape[0], 1, 2)[:, 0]
    assert rel_err(op.tr_mul(torch.from_numpy(xt)), A64.T @ xt) <= TOL
    # the mul_mat at k = 4 ran by block: its row -> blocks map is held too
    assert op.memory_bytes() == (op.host_tr.memory_bytes() + op.host_fw.memory_bytes()
                                 + op.ordered_fw.ordered_maps.nbytes
                                 + op.ordered_fw.row_blocks.nbytes)


def test_fw_on_a_needs_an_f32_pack_of_a():
    A = blocky.generate(0, L=300, dtype="float64")
    with pytest.raises(ValueError, match="f32"):
        vt.VBCOperator.from_host(vt.vbc1d(A, 8), None, None, "cpu", fw_on_a=True)
    with pytest.raises(ValueError, match="f32"):
        vt.VBCOperator.from_host(None, vt.vbc1d(A.T.tocsc(), 8), None, "cpu",
                                 fw_on_a=True)


# ---- the kernel (card) -----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def long_stripes():
    """1,600 rows dense in the first 8 columns (a stripe of A's pack of
    1,600 blocks: the long path) and a diagonal."""
    m = 2048
    rng = np.random.default_rng(7)
    dense = sp.coo_matrix(
        (rng.standard_normal(1600 * 8),
         (np.repeat(np.arange(1600), 8), np.tile(np.arange(8), 1600))), shape=(m, m))
    diag = sp.coo_matrix((np.ones(m - 8), (np.arange(8, m), np.arange(8, m))),
                         shape=(m, m))
    return (dense + diag).tocsc().astype(np.float32)


# name -> (matrix, W, chunker) of the card's packs of A
CARD_CASES = {
    **{name: (lambda f=f: (f(), 8, None)) for name, f in MATRICES.items()},
    "long_stripes": lambda: (long_stripes(), 8, vt.EquiChunker(8)),
    "w16": lambda: (rectangular(), 16, vt.EquiChunker(16)),
    "w3": lambda: (blocky.generate(1, L=200), 3, vt.EquiChunker(3)),
}


def card_format(case, device):
    if case == "relabeled":
        A, op = relabeled(device)
    else:
        A, W, method = CARD_CASES[case]()
        op = on_a(A, device, W, method)
    return A, op.ordered_fw


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 32, 128, 130])
@pytest.mark.parametrize("case", sorted(CARD_CASES) + ["relabeled"])
def test_kernel_matches_plain(case, k, cuda_device):
    A, fmt = card_format(case, cuda_device)
    if case == "long_stripes":
        assert fmt.long_stripes.numel() >= 1
    g = torch.Generator(device=cuda_device).manual_seed(k)
    X = torch.randn(A.shape[1], k, device=cuda_device, generator=g)
    launches, maps = mul_ordered.launches, trace.launches_by_map()
    Y = mul_ordered(fmt, X)
    rows = int(k < SECTOR_COLUMNS or fmt.ordered_maps.rows_pass)
    assert mul_ordered.launches == launches + 1 + rows
    assert trace.launches_by_map() == {
        **maps, "ordered_products": maps["ordered_products"] + 1,
        "ordered_rows": maps["ordered_rows"] + rows}
    want = mul_ordered_plain(fmt, X)
    torch.cuda.synchronize()
    assert Y.shape == (A.shape[0], k) and torch.isfinite(Y).all()
    assert rel_err(Y, want.double().cpu().numpy()) <= TOL
    assert rel_err(Y, A.astype(np.float64) @ X.double().cpu().numpy()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 130])
@pytest.mark.parametrize("case", ["blocky_300", "long_stripes", "relabeled"])
def test_kernel_bitwise_across_launches(case, k, cuda_device):
    A, fmt = card_format(case, cuda_device)
    X = torch.randn(A.shape[1], k, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))
    Y0 = mul_ordered(fmt, X)
    Y1 = mul_ordered(fmt, X)
    torch.empty(A.shape[0] * k + 64, device=cuda_device).fill_(float("nan"))
    Y2 = mul_ordered(fmt, X)  # over a buffer that held NaN
    torch.cuda.synchronize()
    assert torch.equal(Y0, Y1) and torch.equal(Y0, Y2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8, 32])
@pytest.mark.parametrize("case", sorted(CARD_CASES) + ["relabeled"])
def test_by_block_and_by_slot_agree_bitwise(case, k, cuda_device):
    """The launches by block (every block's row to slot b, the rows
    through ``row_blocks``), which ``mul_ordered`` runs below
    ``SECTOR_COLUMNS``, and by slot, which it runs from there on, sum
    every row in one order: Y has the same bits, with alpha/beta/y too."""
    A, fmt = card_format(case, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    X = torch.randn(A.shape[1], k, device=cuda_device, generator=g)
    y_in = torch.randn(A.shape[0], k, device=cuda_device, generator=g)
    for args in ((None, 1.0, 0.0), (y_in, 0.5, 0.25)):
        out = []
        for by_block in (True, False):
            Y = torch.full((A.shape[0], k), float("nan"), device=cuda_device)
            slots = fmt.idx.numel() if by_block else fmt.ordered_maps.slots
            part = torch.empty(max(slots, 1) * k, device=cuda_device)
            if fmt.idx.numel():
                launch_products(fmt, X, Y, part, *args, by_block=by_block)
            if by_block or fmt.ordered_maps.rows_pass:
                launch_rows(fmt, k, Y, part, *args, by_block=by_block)
            out.append(Y)
        torch.cuda.synchronize()
        assert torch.equal(out[0], out[1])
        assert torch.equal(out[0], mul_ordered(fmt, X, args[1], args[2], args[0])
                           if args[0] is not None else mul_ordered(fmt, X))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 32])
@pytest.mark.parametrize("case", ["blocky_300", "rectangular", "long_stripes"])
def test_kernel_misaligned_x_takes_the_scalar_path(case, k, cuda_device):
    """X one float past 16 bytes (the float4 path refused) gives the bits
    of an aligned copy, which take the float4 path, by block (k = 4) and
    by slot (k = 32)."""
    A, fmt = card_format(case, cuda_device)
    buf = torch.randn(A.shape[1] * k + 1, device=cuda_device,
                      generator=torch.Generator(device=cuda_device).manual_seed(2))
    X = buf[1:].view(A.shape[1], k)
    assert X.data_ptr() % 16 != 0 and X.is_contiguous()
    got = mul_ordered(fmt, X)
    want = mul_ordered(fmt, X.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rel_err(got, A.astype(np.float64) @ X.double().cpu().numpy()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blocky_300", "hpcg_8", "shaped_rows", "relabeled"])
def test_kernel_alpha_beta_y(case, cuda_device):
    A, fmt = card_format(case, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(A.shape[1], device=cuda_device, generator=g)
    y = torch.randn(A.shape[0], device=cuda_device, generator=g)
    X = torch.randn(A.shape[1], 8, device=cuda_device, generator=g)
    Yin = torch.randn(A.shape[0], 8, device=cuda_device, generator=g)
    for args in ((x, 0.5, 0.25, y), (x, 2.0), (X, 0.5, -1.5, Yin)):
        got = mul_ordered(fmt, *args)
        want = mul_ordered_plain(fmt, *args)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert rel_err(got, want.double().cpu().numpy()) <= TOL


@pytest.mark.cuda
def test_operator_forward_on_card(cuda_device):
    """The small blocky forward operator on the card: ``mul_mat`` and
    ``mul`` run the ordered scatter (two launches a call, no ``tr_spmm``
    nor ``tr_spmv``), within the tolerance of ``A @ X``; the "both"
    operator runs ``mul_mat`` there and ``mul`` on its A.T pack's route."""
    A = blocky.generate(0, L=300)
    op = vt.VBCOperator.from_csc(A, W=8, directions="forward", device=cuda_device)
    assert op.fw_on_a
    X = torch.randn(A.shape[1], 32, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(4))
    before = (trace.launches(), vt.tr_spmm.launches, vt.tr_spmv.launches)
    Y = op.mul_mat(X)
    y = op.mul(X[:, 0].contiguous(), 0.5, 0.25, Y[:, 1].contiguous())
    torch.cuda.synchronize()
    assert (trace.launches(), vt.tr_spmm.launches, vt.tr_spmv.launches) == (
        before[0] + 4, before[1], before[2])
    A64, Xh = A.astype(np.float64), X.double().cpu().numpy()
    assert rel_err(Y, A64 @ Xh) <= TOL
    assert rel_err(y, 0.5 * (A64 @ Xh[:, 0]) + 0.25 * Y[:, 1].double().cpu().numpy()) <= TOL
    both = vt.VBCOperator.from_csc(A, W=8, device=cuda_device)
    assert both.fw_on_a
    name, _, call = both.route_fw
    before = (mul_ordered.launches, call.launches)
    yb = both.mul(X[:, 0].contiguous(), 0.5, 0.25, Y[:, 1].contiguous())
    Yb = both.mul_mat(X)
    torch.cuda.synchronize()
    assert name in ("stripe", "scatter")
    assert (mul_ordered.launches, call.launches) == (before[0] + 2, before[1] + 1)
    assert rel_err(Yb, A64 @ Xh) <= TOL
    assert rel_err(yb, 0.5 * (A64 @ Xh[:, 0]) + 0.25 * Y[:, 1].double().cpu().numpy()) <= TOL
