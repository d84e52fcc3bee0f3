"""``op.mul_mat(X)``: ``A @ X`` for a dense ``X [n, k]`` (SpMM)."""

from __future__ import annotations

import torch


def operands(t, m, n, gen, device, dtype):
    return [torch.randn(n, t["k"], generator=gen, device=device, dtype=dtype)
            for _ in range(t["operands"])]


def first_y(t, m, n, gen, device, dtype):
    return None


def invoke(op, t, x, y):
    return op.mul_mat(x)


def expect(ref, t, x, y):
    return ref.product(x, transpose=False)
