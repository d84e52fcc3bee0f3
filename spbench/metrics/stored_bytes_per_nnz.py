"""The packed direction's bytes (``op.memory_bytes()``: values and
index arrays) per nonzero of the matrix: an exact count."""


def read(run):
    if run.stored_bytes is None or run.nnz == 0:
        return None
    return run.stored_bytes / run.nnz
