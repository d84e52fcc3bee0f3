"""``A @ X`` for an m x n ``A`` and ``X [n, k]``: X read once, Y [m, k]
written once."""


def count(nnz, m, n, t):
    k = t["k"]
    return {"products": nnz * k, "bytes": 4 * (nnz + n * k + m * k),
            "flops": 2 * nnz * k}
