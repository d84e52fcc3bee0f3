"""``op.tr_mul_chain(x, n_iters, alpha)``: ``(alpha * A.T)^n_iters @ x``."""

from __future__ import annotations

import torch


def operands(t, m, n, gen, device, dtype):
    return [torch.randn(m, generator=gen, device=device, dtype=dtype)
            for _ in range(t["operands"])]


def first_y(t, m, n, gen, device, dtype):
    return None


def invoke(op, t, x, y):
    return op.tr_mul_chain(x, t["n_iters"], t.get("alpha"))


def expect(ref, t, x, y):
    return ref.chain(x, t["n_iters"], t.get("alpha"))
