"""``device_idle_share``, read alike in the synchronous cells, where it moves
``call_p95_us`` (those cells report no ``gnnz_s``)."""

from spbench.metrics.device_idle_share import read  # noqa: F401
