"""The control: the reference put in the port's place, computed one
precision below what the configuration states (float32 with TF32 off):
operands rounded to TF32, products summed in float32.  A run with it in
the operator's place has to come out as not correct; ``calibrate.py``
reads it on the card and ``tests/`` at a small size.  The benchmark's
own runs never use it."""

from __future__ import annotations

import torch

from .reference import Matrix


class ControlOperator:
    """The four calls of ``VBCOperator`` that the traffic mixes drive,
    in TF32."""

    def __init__(self, A, device):
        self.A = Matrix(A, device, dtype=torch.float32, tf32=True)

    @staticmethod
    def _axpby(out, alpha, beta, y):
        if alpha is not None:
            out = out * alpha
        if beta is not None and y is not None:
            out = out + beta * y
        return out

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        return self._axpby(self.A.product(x, transpose=True), alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        return self._axpby(self.A.product(x, transpose=False), alpha, beta, y)

    def mul_mat(self, X):
        return self.A.product(X, transpose=False)

    def tr_mul_chain(self, x, n_iters, alpha=None):
        return self.A.chain(x, n_iters, alpha)
