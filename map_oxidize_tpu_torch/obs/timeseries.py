"""Ring-buffer time-series recorder: the metrics registry over time.  A
copy of the JAX package's ``obs/timeseries.py`` (``TimeSeriesRecorder``
:44).

A sampler thread snapshots every counter, gauge and histogram quantile
(plus the live device-memory gauges the device sampler keeps and the
job's live launch-ledger compile counts) every ``obs_sample_s`` into a
bounded ring: old samples are overwritten, so a long-lived resident
server holds a fixed telemetry footprint.

Exports two ways:

* the ``series`` section of the metrics document: ``{"schema":
  "moxt-series-v1", "interval_s", "t_unix_s": [...], "series": {name:
  [...]}}`` with per-name value lists aligned to the timestamp list
  (``None`` where a series had not started yet);
* the live ``/series`` endpoint (:mod:`map_oxidize_tpu_torch.obs.serve`),
  same shape, readable mid-run under concurrent scrape.

Overhead per tick is one locked dict copy of the registry on a daemon
thread; the hot paths are untouched.
"""

from __future__ import annotations

import threading
import time

SERIES_SCHEMA = "moxt-series-v1"

#: ring capacity (samples): at the 1 s default interval this is ~17 min
#: of history; longer jobs keep the most recent window, which is what a
#: live view needs — the full-job aggregates are the registry's job
DEFAULT_CAPACITY = 1024

#: histogram stats carried per series sample
_HIST_STATS = ("p50", "p95")


class TimeSeriesRecorder:
    """Samples one job's :class:`~map_oxidize_tpu_torch.obs.metrics.
    MetricsRegistry` into a bounded ring on a daemon thread.

    ``interval_s`` is the tick; ``capacity`` bounds the ring.  ``clock``
    is injectable for tests (the thread is optional — :meth:`sample_once`
    is the whole tick and is public)."""

    def __init__(self, registry, interval_s: float = 1.0,
                 capacity: int = DEFAULT_CAPACITY, clock=time.time,
                 heartbeat=None, obs=None, on_sample=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.registry = registry
        #: optional heartbeat: its live row/byte progress becomes the
        #: ``progress/rows`` / ``progress/bytes_done`` series
        self.heartbeat = heartbeat
        #: optional owning Obs bundle: with it, each tick also snapshots
        #: the job's LIVE compile-ledger overlay into ``compile/*``
        #: series — the registry only receives those counters at finish,
        #: but the SLO plane's recompile rules need them mid-run
        self.obs = obs
        self.interval_s = interval_s
        self.capacity = capacity
        self._clock = clock
        #: optional tap called with each ``(unix_ts, {name: value})``
        #: sample right after it lands in the ring (outside the lock) —
        #: the fleet collector's series archive appends exactly what was
        #: sampled, including the final stop() sample.  A tap error is
        #: swallowed: persistence must never stop telemetry sampling
        self.on_sample = on_sample
        #: ring of (unix_ts, {name: value}) snapshots; _head is the next
        #: write slot once the ring has wrapped
        self._ring: list = []
        self._head = 0
        self.samples_taken = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-timeseries")

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop the thread and take one final sample so the exported
        series always includes the job's end state (jobs shorter than one
        interval still get a point)."""
        self._stop.set()
        self.sample_once()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    # --- sampling ---------------------------------------------------------

    def _snapshot(self) -> dict:
        """One flat {name: scalar} reading of the registry: counters and
        numeric gauges by name, histograms as ``<name>/p50``/``p95`` and
        ``<name>/count`` (the count series is what rate-of-progress reads
        come from)."""
        reg = self.registry
        snap: dict = {}
        with reg._lock:
            for k, v in reg.counters.items():
                snap[k] = v
            for k, v in reg.gauges.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    snap[k] = v
            for k, h in reg.histograms.items():
                snap[f"{k}/count"] = h.count
                for stat in _HIST_STATS:
                    q = h.quantile(0.50 if stat == "p50" else 0.95)
                    if q is not None:
                        snap[f"{k}/{stat}"] = q
        hb = self.heartbeat
        if hb is not None:
            snap["progress/rows"] = hb.rows
            if hb.bytes_done:
                snap["progress/bytes_done"] = hb.bytes_done
        if self.obs is not None and getattr(self.obs, "xprof_base",
                                            None) is not None:
            from map_oxidize_tpu_torch.obs.compile import job_overlay_delta

            total = 0
            for prog, d in job_overlay_delta(self.obs).items():
                snap[f"compile/{prog}/compiles"] = d["compiles"]
                total += d["compiles"]
            snap["compile/total_compiles"] = total
        return snap

    def sample_once(self) -> None:
        # the resident SERVER's own bundle has no job wall to decompose
        # (it idles between jobs; each job's bundle attributes itself)
        if (self.obs is not None
                and getattr(self.obs, "workload", None) != "serve"):
            # refresh the live wall attribution FIRST: the attrib/*
            # gauges (and the heartbeat's where= token) are maintained
            # at the sampling cadence, so this tick's snapshot — and
            # every /status, /metrics, /series read between ticks —
            # carries a current decomposition
            try:
                from map_oxidize_tpu_torch.obs import attrib

                attrib.live_update(self.obs)
            except Exception:  # a decomposition bug must not stop
                pass           # telemetry sampling
        sample = (self._clock(), self._snapshot())
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(sample)
            else:
                self._ring[self._head] = sample
                self._head = (self._head + 1) % self.capacity
            self.samples_taken += 1
        if self.on_sample is not None:
            try:
                self.on_sample(sample[0], sample[1])
            except Exception:  # persistence must never stop sampling
                pass

    # --- export -----------------------------------------------------------

    def latest_names(self) -> list[str]:
        """Series names present in the NEWEST sample — the full current
        name set (registry keys are never deleted, so the newest
        snapshot is a superset of every older one).  Cheap: one locked
        key-list copy, no aligned-list construction — what the SLO
        evaluator globs against each tick before asking for a targeted
        :meth:`export`."""
        with self._lock:
            if not self._ring:
                return []
            newest = (self._ring[self._head - 1]
                      if len(self._ring) == self.capacity
                      else self._ring[-1])
            return list(newest[1].keys())

    def export(self, only=None) -> dict:
        """The ``series`` document: timestamps plus aligned per-name value
        lists, oldest sample first.  Safe to call at any time (including
        under concurrent ticks).  ``only`` (a set of names) restricts the
        aligned-list construction to those series — the evaluator's
        per-tick reads must not pay for the whole ring."""
        with self._lock:
            ordered = self._ring[self._head:] + self._ring[:self._head]
            samples_taken = self.samples_taken
        t = [round(ts, 3) for ts, _ in ordered]
        names: dict[str, None] = {}
        for _ts, snap in ordered:
            for k in snap:
                if only is None or k in only:
                    names.setdefault(k)
        series = {name: [snap.get(name) for _ts, snap in ordered]
                  for name in names}
        return {
            "schema": SERIES_SCHEMA,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "samples_taken": samples_taken,
            "t_unix_s": t,
            "series": series,
        }
