"""map_oxidize_tpu_torch — the PyTorch/CUDA port of map_oxidize_tpu.

A second package beside the JAX one, with the same workloads, CLI surface
and output bytes.  Plain tensor code is PyTorch; the JAX package's Pallas
TPU kernel is a CUDA kernel written by hand for Hopper (``ops/csrc``), built
at first use.  Every entry point runs on the CUDA device unless the caller
asks for the CPU (``backend='cpu'``), where each kernel's plain PyTorch
version runs instead.

Layer map (mirrors the JAX package):

* ``runtime.driver`` — job drivers: word count, device-resident k-means
* ``runtime.engine`` — streaming device reduce engine
* ``serve``          — the resident job service (``python -m
  map_oxidize_tpu_torch serve`` / ``submit``)
* ``obs``            — per-job observability, the run ledger and the live
  plane (``/metrics``, ``/status``, ``/series``, ``/alerts``, ``/jobs``)
* ``api``            — Mapper / Reducer boundary
* ``ops``            — hashing, sort + segment reduce, top-k, k-means kernel
* ``io``             — splitter / writer
* ``convert``        — engine state to and from the JAX package
"""

__version__ = "0.5.0"  # keep in sync with pyproject.toml
