"""Counters, gauges and lightweight histograms: the port of the JAX
package's ``obs/metrics.py``.

:class:`MetricsRegistry` keeps the seed ``Metrics`` surface (``phase`` /
``count`` / ``set`` / ``summary``) with the JAX package's key names and
rounding (``time/<phase>_s`` to 4 places, the derived ``records_per_sec``,
flattened histogram quantiles), so a job of the port reports the same keys
as the same job of the JAX package:

* **counters** — accumulated (rows fed, bytes put, per-chunk waits);
* **gauges** — last value or watermark (``gauge_max``: host RSS, device
  memory);
* **histograms** — p50/p95/max over per-event observations (per-block feed
  latency, flush latency) in bounded memory.

The device-memory watermarks read ``torch.cuda.memory_stats`` under the JAX
package's ``mem/device{i}_hbm_*`` names.  The comms observatory
(``comm`` / ``comms_table``, JAX ``obs/metrics.py:216``, ``:246``) holds
the rows the sharded engines record per collective, and
:func:`sample_collective_wall` their sampled latencies.

All mutating entry points take one lock; the hot paths record at chunk or
flush cadence, where contention is negligible.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import threading
import time

#: default cumulative-bucket bounds for latency histograms, in ms — 5 ms to
#: 10 min, roughly log-spaced (the serve job-latency SLO metrics: queue
#: wait, admission wait, run wall; JAX ``obs/metrics.py:40``)
LATENCY_BUCKETS_MS = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    10_000.0, 30_000.0, 60_000.0, 120_000.0, 300_000.0, 600_000.0)


class Histogram:
    """Streaming summary of one observation series (JAX
    ``obs/metrics.py:45``).

    Exact ``count``/``sum``/``min``/``max``; quantiles come from a
    deterministic sample: every ``stride``-th observation is kept, and when
    the kept set reaches ``max_samples`` it is decimated 2:1 and the stride
    doubles — bounded memory, no RNG, and the sample stays uniformly spread
    over the series.

    ``buckets`` (a sorted sequence of upper bounds) additionally keeps exact
    fixed-bucket counts, so the histogram exports as a cumulative-bucket
    Prometheus histogram (``_bucket{le=...}``); the serve job-latency
    histograms use :data:`LATENCY_BUCKETS_MS`.
    """

    __slots__ = ("count", "total", "min", "max", "_samples", "_stride",
                 "_max_samples", "buckets", "bucket_counts")

    def __init__(self, max_samples: int = 8192, buckets=None):
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._samples: list[float] = []
        self._stride = 1
        self._max_samples = max_samples
        #: fixed upper bounds (an implicit +Inf bucket rides at the end);
        #: None = a summary-only histogram
        self.buckets: tuple | None = (
            tuple(sorted(float(b) for b in buckets)) if buckets else None)
        self.bucket_counts: list[int] | None = (
            [0] * (len(self.buckets) + 1) if self.buckets else None)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if self.buckets is not None:
            self.bucket_counts[bisect.bisect_left(self.buckets,
                                                  value)] += 1
        if self.count % self._stride == 0:
            self._samples.append(value)
            if len(self._samples) >= self._max_samples:
                self._samples = self._samples[1::2]
                self._stride *= 2

    def cumulative_buckets(self) -> list[tuple[float, int]] | None:
        """``(le, cumulative_count)`` pairs ending at ``(+inf, count)``, or
        None for a summary-only histogram."""
        if self.buckets is None:
            return None
        out, acc = [], 0
        for le, n in zip(self.buckets, self.bucket_counts):
            acc += n
            out.append((le, acc))
        out.append((float("inf"), self.count))
        return out

    def quantile(self, q: float) -> float | None:
        if not self._samples:
            return self.max
        s = sorted(self._samples)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def summary(self) -> dict:
        s = {
            "count": self.count,
            "mean": round(self.total / self.count, 6) if self.count else 0.0,
            "p50": _round6(self.quantile(0.50)),
            "p95": _round6(self.quantile(0.95)),
            "max": _round6(self.max),
        }
        if self.buckets is not None:
            s["buckets"] = {
                ("+Inf" if le == float("inf") else f"{le:g}"): n
                for le, n in self.cumulative_buckets()}
        return s


def _round6(v):
    return None if v is None else round(v, 6)


class MetricsRegistry:
    """Thread-safe registry of phases, counters, gauges and histograms
    (JAX ``obs/metrics.py:136``).

    ``summary()`` returns the flat dict a job's result carries:
    ``time/<phase>_s`` keys, counters and gauges by plain name, the derived
    ``records_per_sec`` and ``<hist>/{p50,p95,max,count}`` entries.
    """

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        #: comms observatory rows: (collective, program, shape) ->
        #: {count, bytes, latency histogram}
        self._comms: dict[tuple, dict] = {}
        #: sticky Prometheus export-name assignments for this registry's
        #: lifetime ((kind, name) -> moxt_* name, plus the taken set): a
        #: key created later must never take the name of an already
        #: exported series (obs/serve.py's exporter fills them)
        self._prom_names: dict = {}
        self._prom_used: set = set()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.phases[name] = self.phases.get(name, 0.0) + dt

    def count(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def set(self, name: str, value) -> None:
        """Record a last-value gauge."""
        with self._lock:
            self.gauges[name] = value

    gauge = set

    def gauge_max(self, name: str, value: float) -> None:
        """Watermark gauge: keeps the maximum ever recorded."""
        with self._lock:
            if value > self.gauges.get(name, float("-inf")):
                self.gauges[name] = value

    def observe(self, name: str, value: float, buckets=None) -> None:
        """Add one observation to the named histogram (created lazily).
        ``buckets`` (applied at creation) also keeps exact cumulative-bucket
        counts for the Prometheus ``_bucket{le=...}`` export."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(buckets=buckets)
            h.observe(value)

    # --- comms observatory ------------------------------------------------

    def comm(self, collective: str, program: str, nbytes: float,
             shape=None, latency_ms: float | None = None) -> None:
        """Record one collective invocation: ``collective`` is the
        primitive (``all_to_all`` / ``psum`` / ``all_gather``), ``program``
        the device program it runs in, ``nbytes`` the global payload it
        moved (the host-side accounting identity), ``shape`` the per-shard
        buffer shape, ``latency_ms`` the sampled wall where the site
        measures one.  Accumulates the per-(collective, program, shape)
        table of the metrics document's ``comms`` section and the flat
        ``comms/<collective>/<program>/{bytes,calls}`` counters."""
        key = (collective, program, _shape_str(shape))
        with self._lock:
            row = self._comms.get(key)
            if row is None:
                row = self._comms[key] = {
                    "count": 0, "bytes": 0.0, "latency": Histogram(1024)}
            row["count"] += 1
            row["bytes"] += nbytes
            if latency_ms is not None:
                row["latency"].observe(latency_ms)
            for name, delta in (
                    (f"comms/{collective}/{program}/bytes", nbytes),
                    (f"comms/{collective}/{program}/calls", 1)):
                self.counters[name] = self.counters.get(name, 0) + delta

    def comms_table(self) -> list[dict]:
        """The per-(collective, program, shape) rows, by bytes
        descending."""
        rows = []
        with self._lock:
            for (collective, program, shape), r in self._comms.items():
                lat = (r["latency"].summary() if r["latency"].count
                       else None)
                rows.append({
                    "collective": collective, "program": program,
                    "shape": shape, "count": r["count"],
                    "bytes": int(r["bytes"]), "latency_ms": lat,
                })
        rows.sort(key=lambda row: -row["bytes"])
        return rows

    def summary(self) -> dict:
        """The flat dict: phase wall-clocks, counters, gauges, the derived
        throughput (records over ``map+reduce`` + ``finalize``, JAX
        ``obs/metrics.py:280-285``) and flattened histogram entries."""
        with self._lock:
            out = {f"time/{k}_s": round(v, 4) for k, v in self.phases.items()}
            out.update(self.counters)
            out.update(self.gauges)
            merged = {**self.counters, **self.gauges}
            hists = list(self.histograms.items())
            phases = dict(self.phases)
        for name, h in hists:
            s = h.summary()
            for stat in ("p50", "p95", "max", "count"):
                out[f"{name}/{stat}"] = s[stat]
        total_records = merged.get("records_in")
        map_reduce_s = sum(
            phases.get(p, 0.0) for p in ("map+reduce", "finalize"))
        if total_records and map_reduce_s > 0:
            out["records_per_sec"] = round(total_records / map_reduce_s, 1)
        return out

    def to_dict(self) -> dict:
        """The structured export (the ``metrics_out`` document's registry
        sections): phases, counters, gauges, full histogram summaries and
        the comms table (when a collective ran)."""
        with self._lock:
            out = {
                "phases_s": {k: round(v, 6) for k, v in self.phases.items()},
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.summary()
                               for k, h in self.histograms.items()},
            }
        comms = self.comms_table()
        if comms:
            out["comms"] = comms
        return out


def sample_collective_wall(holder, attr: str, t0: float,
                           target) -> float | None:
    """The sampling rule of the asynchronous collective sites (JAX
    ``obs/metrics.py:306``): on the 1st and then every ``SAMPLE_EVERY``-th
    invocation (counted per ``holder`` in ``attr``, the launch ledger's
    cadence), wait for ``target`` (a tensor, or a list of per-shard
    tensors) and return the wall since ``t0`` in ms; None otherwise."""
    n = getattr(holder, attr, 0) + 1
    setattr(holder, attr, n)
    from map_oxidize_tpu_torch.obs.compile import SAMPLE_EVERY

    if n != 1 and n % SAMPLE_EVERY != 0:
        return None
    import torch

    for t in (target if isinstance(target, (list, tuple)) else [target]):
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _shape_str(shape) -> str:
    """Stable string key for a comms row's buffer shape: a tuple, an
    already-formatted string, or None (shapeless)."""
    if shape is None:
        return "-"
    if isinstance(shape, str):
        return shape
    try:
        return "x".join(str(int(d)) for d in shape)
    except TypeError:
        return str(shape)


def format_bytes(n) -> str:
    """Human-readable byte count (JAX ``obs/metrics.py:345``)."""
    if not isinstance(n, (int, float)):
        return "-"
    for scale, suffix in ((1 << 40, "TB"), (1 << 30, "GB"),
                          (1 << 20, "MB"), (1 << 10, "KB")):
        if n >= scale:
            return f"{n / scale:.2f}{suffix}"
    return f"{n:.0f}B"


def sample_host_memory(registry: MetricsRegistry) -> None:
    """Record host RSS watermarks (JAX ``obs/metrics.py:360``): current
    ``VmRSS`` and the kernel's high-water ``VmHWM`` from
    ``/proc/self/status``, falling back to ``resource.getrusage`` peak RSS
    elsewhere.  Called at phase boundaries, where residency peaks."""
    rss = hwm = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
    except OSError:
        pass
    if hwm is None:
        try:
            import resource

            hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):
            return
    if rss is not None:
        registry.gauge_max("mem/host_rss_bytes", rss)
    registry.gauge_max("mem/host_rss_peak_bytes", hwm)


def loaded_torch():
    """``torch`` if this process has imported it, else None: the live
    plane never imports torch into a process without it (as the JAX
    package reads ``sys.modules`` for jax).  An import in progress on
    another thread is waited for, never read half-initialised."""
    if "torch" not in sys.modules:
        return None
    import torch

    return torch


def sample_device_memory(registry: MetricsRegistry) -> None:
    """Record device-memory watermarks for every CUDA device (JAX
    ``obs/metrics.py:388``, there from ``device.memory_stats()``): the
    caching allocator's ``allocated_bytes.all.current`` and ``.peak`` from
    ``torch.cuda.memory_stats(i)``, under the JAX names
    ``mem/device{i}_hbm_bytes`` and ``mem/device{i}_hbm_peak_bytes``.

    A no-op unless this process has already initialised CUDA: a job with
    ``backend='cpu'`` must not pay (or fail) CUDA initialisation, and a
    process that never imported torch does not import it here (as the JAX
    version skips a process that never imported jax)."""
    torch = loaded_torch()
    if torch is None or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if in_use is not None:
            registry.gauge_max(f"mem/device{i}_hbm_bytes", int(in_use))
        if peak is not None:
            registry.gauge_max(f"mem/device{i}_hbm_peak_bytes", int(peak))
