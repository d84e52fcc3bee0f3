"""``VBCOperator.from_csc(reorder="auto")``: RCM where it shrinks the packs.

The port relabels a square matrix of more than 1,024 rows iff the packs
of ``rcm_symmetric(A)`` for the directions the operator holds (A's for
``"transposed"``, both for ``"both"``; for ``"forward"`` each formulation
of the forward products on its own, A.T's and, for an f32 matrix, A's,
before ``forward_pack`` picks one of the two) store strictly fewer bytes
(``memory_bytes()``) than ``A``'s own.  Each case computes both sums here
and holds the operator to them: the random-row blocky matrix (RCM cuts
its 8-wide stripes, so its A pack grows), a small 27-point stencil and
the scrambled grid Laplacians.  Where it relabels,
the permutation and the packs are ``rcm_symmetric``'s; ``"always"`` and
``"never"`` keep their meaning; ``trace.reorder_choices()`` counts each
decision.  The JAX operator's decision is compared in
``test_torch_operator.py::test_auto_rcm_decision_matches_jax``.
"""

import os
import sys

import numpy as np
import pytest

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.utils import trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import fem_matrix  # noqa: E402
from spbench.gen import blocky, hpcg27  # noqa: E402

MATRICES = {
    "blocky_random_rows": lambda: blocky.generate(5, L=400),  # 3,200 rows
    "stencil27_11": lambda: hpcg27.generate(None, nx=11, ny=11, nz=11),
    "stencil27_11_f64": lambda: hpcg27.generate(None, nx=11, ny=11, nz=11,
                                                dtype="float64"),
    "fem40": lambda: fem_matrix(k=40).astype(np.float32),
    "fem64": lambda: fem_matrix(k=64).astype(np.float32),
    "fem80": lambda: fem_matrix(k=80).astype(np.float32),
}
DIRECTIONS = ["transposed", "forward", "both"]


def held(C, directions):
    """The packs ``from_csc`` weighs for ``C`` (the default method, W=8):
    A's, A.T's or both."""
    out = []
    if directions in ("both", "transposed"):
        out.append(vt.vbc1d(C, 8))
    if directions in ("both", "forward"):
        out.append(vt.vbc1d(C.transpose(), 8))
    return out


def stored(packs):
    return sum(B.memory_bytes() for B in packs)


def expected(C, Cp, perm, directions):
    """``(packs held, perm or None, fw_on_a)`` by the rule: the labelling
    of fewer stored bytes for what the operator holds and, for a forward
    f32 operator, in each formulation, then ``forward_pack``."""
    if directions != "forward" or C.val.dtype != np.float32:
        natural, relabeled = held(C, directions), held(Cp, directions)
        take = stored(relabeled) < stored(natural)
        packs = relabeled if take else natural
        fw_on_a = (directions == "both" and C.val.dtype == np.float32
                   and vt.forward_pack(*packs) == "A")
        return packs, perm if take else None, fw_on_a
    (at, at_perm), (a, a_perm) = (
        min(((held(M, d)[0], p) for M, p in ((C, None), (Cp, perm))),
            key=lambda c: c[0].memory_bytes())
        for d in ("forward", "transposed"))
    if vt.forward_pack(a, at) == "A":
        return [a], a_perm, True
    return [at], at_perm, False


def build(A, directions, reorder="auto"):
    return vt.VBCOperator.from_csc(A, W=8, directions=directions, reorder=reorder,
                                   device="cpu")


def same_packs(op, packs):
    got = [h for h in (op.host_tr, op.host_fw) if h is not None]
    assert len(got) == len(packs)
    for g, w in zip(got, packs):
        for f in ("pos", "idx", "ofs", "val"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        np.testing.assert_array_equal(g.Phi.spl, w.Phi.spl)


@pytest.mark.parametrize("directions", DIRECTIONS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_decision_follows_the_bytes(name, directions):
    A = MATRICES[name]()
    C = vt.CSC.from_scipy(A)
    Cp, perm = vt.rcm_symmetric(C)
    packs, want_perm, fw_on_a = expected(C, Cp, perm, directions)
    op = build(A, directions)
    assert (op.row_perm is not None) == (want_perm is not None)
    if want_perm is not None:
        np.testing.assert_array_equal(op.row_perm, want_perm)
    assert op.fw_on_a == fw_on_a
    same_packs(op, packs)
    maps = 4 * (packs[0].num_blocks + packs[0].m + 1) if fw_on_a else 0
    assert op.memory_bytes() == stored(packs) + maps


@pytest.mark.parametrize("directions", DIRECTIONS)
def test_random_row_blocky_keeps_its_stripes(directions):
    """RCM cuts the 8-wide stripes of A (its pack grows) and shrinks A.T's
    pack: A is kept wherever the operator holds A's pack, which a forward
    operator now does too (its products by the ordered scatter on A's
    pack move fewer bytes than the gather on A.T's)."""
    A = MATRICES["blocky_random_rows"]()
    op = build(A, directions)
    assert op.row_perm is None
    assert op.host_tr is not None and op.fw_on_a == (directions != "transposed")
    if op.host_tr is not None:
        widths = np.diff(np.asarray(op.host_tr.Phi.spl))
        assert (widths == 8).all()
        assert op.dev_tr.quad_widths  # the stripe kernel's float4 map
        assert op.host_tr.memory_bytes() / A.nnz < 5.4
    # the relabeled matrix would make it narrower
    Cp, _ = vt.rcm_symmetric(vt.CSC.from_scipy(A))
    assert np.diff(np.asarray(vt.vbc1d(Cp, 8).Phi.spl)).mean() < 4


def test_always_and_never_keep_their_meaning():
    A = MATRICES["blocky_random_rows"]()
    C = vt.CSC.from_scipy(A)
    Cp, perm = vt.rcm_symmetric(C)
    op = build(A, "transposed", "always")
    np.testing.assert_array_equal(op.row_perm, perm)
    same_packs(op, held(Cp, "transposed"))
    op = build(MATRICES["fem80"](), "transposed", "never")
    assert op.row_perm is None


def test_reorder_choices_counts_each_decision():
    before = trace.reorder_choices()
    assert set(before) == {"natural", "rcm"}
    build(MATRICES["blocky_random_rows"](), "transposed")  # natural
    build(MATRICES["blocky_random_rows"](), "forward")  # natural (A's pack)
    build(MATRICES["fem40"](), "both")  # rcm
    build(MATRICES["fem40"](), "forward")  # rcm
    # no decision: forced either way, at most 1,024 rows, or not square
    build(MATRICES["fem80"](), "transposed", "always")
    build(MATRICES["fem80"](), "transposed", "never")
    build(fem_matrix(k=32).astype(np.float32), "both")
    build(MATRICES["blocky_random_rows"]()[:, :3000].tocsc(), "both")
    assert trace.reorder_choices() == {"natural": before["natural"] + 2,
                                       "rcm": before["rcm"] + 2}
    # a copy: the caller cannot change the count
    trace.reorder_choices()["rcm"] = -1
    assert trace.reorder_choices()["rcm"] == before["rcm"] + 2
