"""Per-job observability of the port: spans, metrics, a progress heartbeat,
the wall attribution, the data-plane audit and the flight recorder.  The
port of the JAX package's ``obs/__init__.py`` ``Obs`` (:126), trimmed to
the surfaces the port's jobs run:

* :class:`~map_oxidize_tpu_torch.obs.trace.Tracer` — nested, thread-safe
  spans, exported as Chrome trace-event JSON (``trace_out``);
* :class:`~map_oxidize_tpu_torch.obs.metrics.MetricsRegistry` — phases,
  counters, gauges and histograms; its flat ``summary()`` is a job
  result's ``metrics`` and its ``to_dict()`` the ``metrics_out`` document;
* :class:`~map_oxidize_tpu_torch.obs.heartbeat.Heartbeat` — opt-in
  progress lines (``progress``);
* :mod:`~map_oxidize_tpu_torch.obs.attrib` — where the job's wall went
  (``attrib/*``);
* :mod:`~map_oxidize_tpu_torch.obs.dataplane` — per-partition row
  conservation and key skew (``data/*``, on unless ``data_audit`` is off);
* :mod:`~map_oxidize_tpu_torch.obs.flight` — the crash envelope
  (``crash_dir``) every driver body runs in;
* :mod:`~map_oxidize_tpu_torch.obs.profiler` — the whole-job
  ``torch.profiler`` trace (``trace_dir``).

One ``Obs`` is created per job and handed to the layers that record into
it (driver, engine, pipeline, checkpoint store).  The compile ledger,
roofline, calibration store, planner, critical path, SLO evaluator, live
server and time series of the JAX package are not ported yet; their hooks
are left out, not stubbed.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

from map_oxidize_tpu_torch.obs.context import current_obs, use_obs
from map_oxidize_tpu_torch.obs.heartbeat import Heartbeat
from map_oxidize_tpu_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    sample_device_memory,
    sample_host_memory,
)
from map_oxidize_tpu_torch.obs.trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Heartbeat",
    "Histogram",
    "JobCancelled",
    "MetricsRegistry",
    "NULL_SPAN",
    "Obs",
    "Span",
    "Tracer",
    "observe_device_wait",
    "sample_device_memory",
    "sample_host_memory",
    "write_json_atomic",
]


class JobCancelled(RuntimeError):
    """Cooperative cancellation, raised by :meth:`Obs.poll_cancel` inside
    the job body, so the abort takes the flight-recorder path."""


@dataclass
class Obs:
    """Per-job observability bundle: one registry, one tracer and an
    optional heartbeat, threaded through driver -> engine -> pipeline.

    Always constructed; the tracer is enabled only when the job asked for
    a trace, and its disabled spans are a shared no-op object, so the
    hot-path cost of an un-traced run is one attribute check per span
    site.
    """

    registry: MetricsRegistry
    tracer: Tracer
    heartbeat: Heartbeat | None = None
    #: this process's slot and the job's process count (stamped into every
    #: document; 0 / 1 for the single-process drivers of the port)
    process: int = 0
    n_processes: int = 1
    #: the phase currently open (``phase``) and the workload recorded
    current_phase: "str | None" = None
    workload: "str | None" = None
    #: cooperative cancellation: set from any thread by
    #: :meth:`request_cancel`, observed at phase starts and per-block feeds
    cancel_event: threading.Event = field(default_factory=threading.Event)
    cancel_reason: "str | None" = None
    #: the data-plane audit, created by :meth:`ensure_dataplane`; stays
    #: None when ``config.data_audit`` is off
    dataplane: "object | None" = None
    dataplane_enabled: bool = True
    #: first-phase latch for the ``attrib/pre_phase_ms`` stamp
    _setup_stamped: bool = False

    @classmethod
    def from_config(cls, config) -> "Obs":
        """Build the bundle a job's config asks for.  ``trace_out='-'``
        collects the trace for ``result.trace`` without writing a file."""
        hb = None
        if config.progress:
            total = None
            try:
                total = os.path.getsize(config.input_path)
            except OSError:
                pass
            hb = Heartbeat(total_bytes=total,
                           interval_s=config.progress_interval_s)
        return cls(registry=MetricsRegistry(),
                   tracer=Tracer(enabled=bool(config.trace_out)),
                   heartbeat=hb, dataplane_enabled=bool(config.data_audit))

    def ensure_dataplane(self, n_partitions: int, conserves: bool = True):
        """Create (once) and return the data-plane audit, or None when
        ``config.data_audit`` disabled it."""
        if not self.dataplane_enabled:
            return None
        if self.dataplane is None:
            from map_oxidize_tpu_torch.obs.dataplane import DataPlaneAudit

            self.dataplane = DataPlaneAudit(n_partitions,
                                            conserves=conserves)
        return self.dataplane

    def finish_dataplane(self) -> "dict | None":
        """Publish the ``data/*`` gauges and return the structured audit
        section (``doc["data"]``); None when no audit ran."""
        if self.dataplane is None:
            return None
        self.dataplane.publish(self.registry)
        return self.dataplane.doc()

    def request_cancel(self, reason: str = "cancelled") -> None:
        """Ask the job to stop at its next cancellation point (a phase
        start or a per-block feed).  Thread-safe; the first reason wins."""
        if not self.cancel_event.is_set():
            self.cancel_reason = reason
            self.cancel_event.set()

    def poll_cancel(self) -> None:
        """Raise :class:`JobCancelled` if a cancel was requested."""
        if self.cancel_event.is_set():
            raise JobCancelled(self.cancel_reason or "cancelled")

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        """One job phase: wall-clocked in the registry (``time/<name>_s``),
        a top-level span in the trace, the heartbeat's phase label, and a
        host-RSS watermark sample on exit.  Also a cancellation point.
        The first phase stamps ``attrib/pre_phase_ms`` (``Obs`` creation to
        here: the attribution's ``setup`` source)."""
        self.poll_cancel()
        if not self._setup_stamped:
            self._setup_stamped = True
            self.registry.set(
                "attrib/pre_phase_ms",
                round(max(time.time() - self.tracer.wall_start, 0.0)
                      * 1e3, 3))
        if self.heartbeat is not None:
            self.heartbeat.set_phase(name)
        prev, self.current_phase = self.current_phase, name
        with self.tracer.span(f"phase/{name}", **attrs):
            with self.registry.phase(name):
                try:
                    yield
                finally:
                    self.current_phase = prev
                    sample_host_memory(self.registry)

    def feed_span(self, **attrs) -> "Span":
        """Span for one mapped block's engine feed, and the job's
        fine-grained cancellation point."""
        self.poll_cancel()
        return self.tracer.span("engine/feed_block", **attrs)

    def stamp(self, config, workload: str | None = None) -> dict:
        """Provenance stamp of every exported document: the package
        version, the identity config hash, the workload and the process
        slot."""
        from map_oxidize_tpu_torch import __version__
        from map_oxidize_tpu_torch.obs.ledger import config_hash

        return {
            "version": __version__,
            "config_hash": config_hash(config),
            "workload": workload,
            "process": self.process,
            "n_processes": self.n_processes,
            "wall_start_unix_s": round(self.tracer.wall_start, 6),
        }

    def finish(self, config, workload: str | None = None
               ) -> tuple[dict, list | None]:
        """End-of-job hook: the wall attribution, the data-plane audit,
        final memory watermarks, the ``metrics_out`` and ``trace_out``
        exports (stamped), and the ``(summary, trace_events)`` pair the
        result carries.  ``trace_events`` is None when tracing was off."""
        from map_oxidize_tpu_torch.obs import attrib

        attrib_doc = attrib.finalize(
            self, max(time.time() - self.tracer.wall_start, 1e-9))
        data_doc = self.finish_dataplane()
        sample_host_memory(self.registry)
        sample_device_memory(self.registry)
        if self.heartbeat is not None:
            self.heartbeat.final_beat()
        meta = self.stamp(config, workload)
        if config.metrics_out:
            doc = dict(self.registry.to_dict(), meta=meta)
            doc["attrib"] = attrib_doc
            if data_doc is not None:
                doc["data"] = data_doc
            write_json_atomic(config.metrics_out, doc)
        trace = self.tracer.chrome_trace() if self.tracer.enabled else None
        if trace is not None:
            trace.insert(0, {"name": "moxt_meta", "ph": "M",
                             "pid": self.tracer._pid, "tid": 0,
                             "args": meta})
            if config.trace_out != "-":
                write_json_atomic(config.trace_out, trace, indent=None)
        return self.registry.summary(), trace

    @contextlib.contextmanager
    def recording(self, config, workload: str | None = None):
        """Crash-safe envelope for a job body: on ANY exception the flight
        recorder closes open spans, flushes the partial metrics/trace to
        their configured paths and dumps a post-mortem bundle under
        ``config.crash_dir``; then the exception propagates unchanged.
        Also binds this bundle as the context's current job
        (:mod:`map_oxidize_tpu_torch.obs.context`)."""
        self.workload = workload
        try:
            with use_obs(self):
                yield self
        except BaseException as exc:
            from map_oxidize_tpu_torch.obs import flight

            flight.record_failure(self, config, exc, workload=workload)
            raise


def observe_device_wait(t0: float) -> None:
    """A blocking device-to-host fetch started at ``t0`` (its wait for the
    device chain that produced the data, plus the copy) into the current
    job's ``device/compute_ms``: the consumer-visible device time of the
    attribution.  Only fetches that block anyway are timed; no sync is
    added.  A no-op outside a job."""
    obs = current_obs()
    if obs is not None:
        obs.registry.observe("device/compute_ms",
                             (time.perf_counter() - t0) * 1e3)


def write_json_atomic(path: str, payload, indent: int | None = 1) -> None:
    """Write ``payload`` as JSON via temp file + rename.  ``indent=None``
    for bulk documents (trace event lists)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent, default=_json_default)
    os.replace(tmp, path)


def _json_default(o):
    """Numpy scalars leak into counters from engine code; make them JSON."""
    item = getattr(o, "item", None)
    if item is not None:
        return item()
    raise TypeError(f"not JSON serializable: {type(o)!r}")
