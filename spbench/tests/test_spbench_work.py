"""The work counts against a count made entry by entry."""

import pytest

from spbench import harness
from spbench.gen import blocky


def explicit(A, t):
    """Count what the call needs by walking its nonzeros and operands."""
    m, n = A.shape
    coo = A.tocoo()
    call = t["call"]
    k = t.get("k", 1)
    iters = t.get("n_iters", 1)
    products = 0
    for _ in range(iters):
        for _ in zip(coo.row, coo.col):
            products += k
    vals = 4 * coo.nnz * iters
    if call in ("tr_mul", "tr_mul_chain"):
        x_len, y_len = m, n
    else:
        x_len, y_len = n, m
    y_in = y_len if t.get("beta") is not None else 0
    operand_bytes = 4 * (x_len * k + y_len * k + y_in) * iters
    return products, vals + operand_bytes, 2 * products


@pytest.mark.parametrize("call,extra", [
    ("tr_mul", {"alpha": 1.0, "beta": 0.5}), ("tr_mul", {}),
    ("mul", {}), ("mul", {"beta": 2.0}), ("mul_mat", {"k": 3}),
    ("tr_mul_chain", {"n_iters": 3, "alpha": 0.5})])
def test_counts(call, extra):
    A = blocky.generate(4, L=6, w=3, d=2)[:, :15]
    t = {"call": call, **extra}
    got = harness.load_module("work", call).count(int(A.nnz), A.shape[0],
                                                  A.shape[1], t)
    products, nbytes, flops = explicit(A, t)
    assert (got["products"], got["bytes"], got["flops"]) == (products, nbytes, flops)


def test_every_traffic_call_has_a_count_and_a_driver():
    for w in harness.load_manifest()["workloads"]:
        t = harness.load_json("traffic", w["traffic"])
        assert hasattr(harness.load_module("work", t["call"]), "count")
        mod = harness.load_module("calls", t["call"])
        for fn in ("operands", "first_y", "invoke", "expect"):
            assert callable(getattr(mod, fn)), (t["call"], fn)
        assert t["direction"] in ("transposed", "forward")
