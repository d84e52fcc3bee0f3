"""The metric readers, one module a metric of ``BENCHMARK.json``:
``read(run) -> float | None`` from ``harness.Run``; None where the run
holds nothing to read, and the harness leaves the metric out."""
