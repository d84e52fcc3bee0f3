"""``op.tr_mul(x, alpha, beta, y)``: ``alpha * A.T @ x + beta * y``
(the reference's ``mul!(y, A', x, alpha, beta)``, ``bin/test_table.jl:80``)."""

from __future__ import annotations

import torch


def operands(t, m, n, gen, device, dtype):
    return [torch.randn(m, generator=gen, device=device, dtype=dtype)
            for _ in range(t["operands"])]


def first_y(t, m, n, gen, device, dtype):
    if t.get("beta") is None:
        return None
    return torch.randn(n, generator=gen, device=device, dtype=dtype)


def invoke(op, t, x, y):
    return op.tr_mul(x, t.get("alpha"), t.get("beta"), y)


def expect(ref, t, x, y):
    out = ref.product(x, transpose=True)
    if t.get("alpha") is not None:
        out = out * t["alpha"]
    if t.get("beta") is not None:
        out = out + t["beta"] * y.to(out.dtype)
    return out
