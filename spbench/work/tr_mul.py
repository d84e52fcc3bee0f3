"""``alpha * A.T @ x + beta * y`` for an m x n ``A``: x [m] read, y [n]
written (and read where beta and y are given)."""


def count(nnz, m, n, t):
    y_reads = n if t.get("beta") is not None else 0
    return {"products": nnz, "bytes": 4 * (nnz + m + n + y_reads),
            "flops": 2 * nnz}
