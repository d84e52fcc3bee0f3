"""spbench: the benchmark of the PyTorch and CUDA port, ``vbcs_tpu_torch``.

One run drives one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on one card and prints one JSON line:

    python3 -m spbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every piece is found by its name in ``BENCHMARK.json``: a configuration
is ``configs/<config>.json`` (its generator ``gen/<generator>.py`` and
arguments), a traffic mix ``traffic/<traffic>.json`` (read by the one
driver in ``harness.py``, calling ``calls/<call>.py``), a metric
``metrics/<metric>.py``, a work count ``work/<call>.py``, a cell's
correctness limit ``limits/<cell>.json``.  A new cell or metric is new
files and new entries, never an edit.  ``reference.py`` (float64, plain
torch) and the work counts import nothing of the port.
"""
