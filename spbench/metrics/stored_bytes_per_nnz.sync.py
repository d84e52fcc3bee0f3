"""``stored_bytes_per_nnz``, read alike in the synchronous cells, where it moves
``call_p95_us`` (those cells report no ``gnnz_s``)."""

from spbench.metrics.stored_bytes_per_nnz import read  # noqa: F401
