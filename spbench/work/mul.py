"""``alpha * A @ x + beta * y`` for an m x n ``A``: x [n] read, y [m]
written (and read where beta and y are given)."""


def count(nnz, m, n, t):
    y_reads = m if t.get("beta") is not None else 0
    return {"products": nnz, "bytes": 4 * (nnz + n + m + y_reads),
            "flops": 2 * nnz}
