"""``VBCOperator.from_csc(reorder="auto")``: RCM where it shrinks the packs.

The port relabels a square matrix of more than 1,024 rows iff the packs
of ``rcm_symmetric(A)`` for the directions the operator holds (A's for
``"transposed"``, A.T's for ``"forward"``, both for ``"both"``) store
strictly fewer bytes (``memory_bytes()``) than ``A``'s own.  Each case
computes both sums here and holds the operator to them: the random-row
blocky matrix (RCM cuts its 8-wide stripes, so its A pack grows), a small
27-point stencil and the scrambled grid Laplacians.  Where it relabels,
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
    """The packs ``from_csc`` holds for ``C`` (the default method, W=8)."""
    out = []
    if directions in ("both", "transposed"):
        out.append(vt.vbc1d(C, 8))
    if directions in ("both", "forward"):
        out.append(vt.vbc1d(C.transpose(), 8))
    return out


def stored(packs):
    return sum(B.memory_bytes() for B in packs)


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
    natural, relabeled = held(C, directions), held(Cp, directions)
    take = stored(relabeled) < stored(natural)
    op = build(A, directions)
    assert (op.row_perm is not None) == take
    if take:
        np.testing.assert_array_equal(op.row_perm, perm)
    same_packs(op, relabeled if take else natural)
    assert op.memory_bytes() == min(stored(relabeled), stored(natural))


@pytest.mark.parametrize("directions", DIRECTIONS)
def test_random_row_blocky_keeps_its_stripes(directions):
    """RCM cuts the 8-wide stripes of A (its pack grows) and shrinks A.T's
    pack: A is kept wherever the operator holds A's pack."""
    A = MATRICES["blocky_random_rows"]()
    op = build(A, directions)
    assert (op.row_perm is None) == (directions != "forward")
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
    build(MATRICES["blocky_random_rows"](), "forward")  # rcm
    build(MATRICES["fem40"](), "both")  # rcm
    # no decision: forced either way, at most 1,024 rows, or not square
    build(MATRICES["fem80"](), "transposed", "always")
    build(MATRICES["fem80"](), "transposed", "never")
    build(fem_matrix(k=32).astype(np.float32), "both")
    build(MATRICES["blocky_random_rows"]()[:, :3000].tocsc(), "both")
    assert trace.reorder_choices() == {"natural": before["natural"] + 1,
                                       "rcm": before["rcm"] + 2}
    # a copy: the caller cannot change the count
    trace.reorder_choices()["rcm"] = -1
    assert trace.reorder_choices()["rcm"] == before["rcm"] + 2
