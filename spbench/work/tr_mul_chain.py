"""``(alpha * A.T)^n_iters @ x``: each iteration one ``A.T @ x`` of a
square ``A`` (its values, x read, y written)."""


def count(nnz, m, n, t):
    it = t["n_iters"]
    return {"products": nnz * it, "bytes": 4 * (nnz + m + n) * it,
            "flops": 2 * nnz * it}
