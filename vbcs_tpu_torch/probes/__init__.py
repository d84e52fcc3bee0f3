"""Micro-probes of the port's kernels on the card.

Ports of the TPU probes under ``bench_tools/``: each asks the question
its TPU probe asked, on the same inputs (built from
``numpy.random.default_rng(0)`` as there), with a kernel written for
Hopper, and prints one line per variant with its time beside its bound.

* ``probe_launch``  — the fixed cost of a launch: eager, in a CUDA graph,
  and through the port's ctypes path (``csrc/probe_launch.cu``);
* ``probe_kernel``, ``probe_kernel2`` — the stripe kernel's chunk split
  into its value stream, x gather and reduction (``chunk.py``,
  ``csrc/probe_chunk.cu``);
* ``probe_chain``   — one persistent launch of the fused chain, split into
  its floor, its gather and its carry (``csrc/probe_chain.cu``);
* ``probe_spmm4``   — the SpMM's load path: a row gather and a streaming
  FMA kernel (``csrc/probe_spmm4.cu``).

Run one on the card with ``python -m vbcs_tpu_torch.probes.probe_<name>``.
Each kernel's wrapper runs its plain PyTorch version on CPU tensors (the
tests hold those against the TPU probes' Pallas bodies in interpret
mode); ``main()`` raises without a CUDA card.
"""
