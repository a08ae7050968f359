"""Resident job service of the port: the JAX package's ``serve/``
(``serve/__init__.py``), one long-lived process that holds CUDA, the
launch ledger's program signatures, the loaded kernel libraries and the
opened corpora, and multiplexes many jobs over the drivers, with
device-memory admission control.

* :mod:`~map_oxidize_tpu_torch.serve.scheduler` — bounded job queue,
  worker threads running the drivers under per-job ``Obs`` bundles
  (disjoint metrics/trace/ledger/compile accounting through the obs
  context), cooperative cancel/deadline through the flight recorder,
  graceful drain;
* :mod:`~map_oxidize_tpu_torch.serve.admission` — admission control:
  admit / defer / reject against the card's memory, with named reasons
  instead of mid-run capacity aborts;
* :mod:`~map_oxidize_tpu_torch.serve.corpus` — opened-corpus cache with
  idle eviction;
* :mod:`~map_oxidize_tpu_torch.serve.server` — the resident process: one
  HTTP plane (the obs telemetry server + ``/jobs`` endpoints), the
  warm-up on the card, signals, lifecycle;
* :mod:`~map_oxidize_tpu_torch.serve.client` — the Python/HTTP client
  behind ``python -m map_oxidize_tpu_torch submit``.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.serve.client import ServeClient
from map_oxidize_tpu_torch.serve.scheduler import Scheduler
from map_oxidize_tpu_torch.serve.server import ResidentServer

__all__ = ["ResidentServer", "Scheduler", "ServeClient"]
