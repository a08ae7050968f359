"""The old import path of the metrics registry and the whole-job trace (JAX
``utils/profiling.py``).

``Metrics`` is :class:`map_oxidize_tpu_torch.obs.metrics.MetricsRegistry`
(counters, gauges, histograms, memory watermarks).  ``device_trace`` is
:func:`map_oxidize_tpu_torch.obs.profiler.device_trace`, the one
``torch.profiler`` implementation, shared with ``POST /profile`` captures.
The JAX module names its alias ``jax_trace`` after ``jax.profiler``; the
port traces with ``torch.profiler`` and has no JAX trace, so the alias
keeps the function's own name.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry as Metrics
from map_oxidize_tpu_torch.obs.profiler import device_trace

__all__ = ["Metrics", "device_trace"]
