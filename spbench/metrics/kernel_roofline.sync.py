"""``kernel_roofline``, read alike in the synchronous cells, where it moves
``call_p95_us`` (those cells report no ``gnnz_s``)."""

from spbench.metrics.kernel_roofline import read  # noqa: F401
