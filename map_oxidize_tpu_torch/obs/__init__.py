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
  ``torch.profiler`` trace (``trace_dir``) and the on-demand deep
  captures of ``POST /profile`` (``profile_dir``, ``host_sample_hz``);
* :mod:`~map_oxidize_tpu_torch.obs.compile` and
  :mod:`~map_oxidize_tpu_torch.obs.xprof` — the launch ledger of every
  observed device program and its roofline rows (``compile/*``,
  ``xprof/*``), plus the device sampler (``hbm_sample_s``,
  ``stall_warn_factor``);
* :mod:`~map_oxidize_tpu_torch.obs.calib` — the cross-run calibration
  store (``calib_dir``);
* :mod:`~map_oxidize_tpu_torch.obs.plan` — the job plan
  (``runtime/planner.py``), published at the start and scored at the end
  (``plan/*``, ``plan='off'`` skips it);
* :mod:`~map_oxidize_tpu_torch.obs.critpath` — the one-process critical
  path (``critpath/*``);
* the live plane (JAX ``Obs.from_config`` :250-300): the time-series ring
  (:mod:`~map_oxidize_tpu_torch.obs.timeseries`, ``obs_sample_s``), the
  SLO evaluator riding it (:mod:`~map_oxidize_tpu_torch.obs.slo`,
  ``slo_rules``, ``incident_dir``) and the HTTP plane
  (:mod:`~map_oxidize_tpu_torch.obs.serve`, ``obs_port``, ``obs_spool``),
  stopped by :meth:`Obs.stop_live` from ``finish`` and the flight
  recorder;
* :mod:`~map_oxidize_tpu_torch.obs.ledger` — the run ledger
  (``ledger_dir``): ``finish`` appends one entry per job.

One ``Obs`` is created per job and handed to the layers that record into
it (driver, engine, pipeline, checkpoint store).  A resident server's own
bundle records under the workload ``serve``: it idles between jobs, so
its finish skips the job-wall decompositions (critical path, plan,
workload calibration).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

# the job-end modules load with the package, not inside a job's first
# finish, where their import would be unattributed wall
from map_oxidize_tpu_torch.obs import attrib, critpath, xprof
from map_oxidize_tpu_torch.obs import calib as _calib
from map_oxidize_tpu_torch.obs import compile as _compile
from map_oxidize_tpu_torch.obs import ledger
from map_oxidize_tpu_torch.obs import plan as _plan
from map_oxidize_tpu_torch.obs.context import current_obs, use_obs
from map_oxidize_tpu_torch.obs.dataplane import (
    ledger_section as dataplane_ledger_section,
)
from map_oxidize_tpu_torch.obs.heartbeat import Heartbeat
from map_oxidize_tpu_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    sample_device_memory,
    sample_host_memory,
)
from map_oxidize_tpu_torch.obs.serve import ObsServer, serve_port_for_process
from map_oxidize_tpu_torch.obs.slo import SloEvaluator, load_rules
from map_oxidize_tpu_torch.obs.timeseries import (
    DEFAULT_CAPACITY,
    TimeSeriesRecorder,
)
from map_oxidize_tpu_torch.obs.trace import NULL_SPAN, Span, Tracer
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

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
    #: document; 0 / 1 for the single-process drivers)
    process: int = 0
    n_processes: int = 1
    #: the phase currently open (``phase``) and the workload recorded
    current_phase: "str | None" = None
    workload: "str | None" = None
    #: cooperative cancellation: set from any thread by
    #: :meth:`request_cancel`, observed at phase starts and per-block feeds
    cancel_event: threading.Event = field(default_factory=threading.Event)
    cancel_reason: "str | None" = None
    #: the device sampler (device-memory watermarks, stall detector) when
    #: the config asks for either (the live plane implies it); stopped by
    #: finish and the flight recorder
    sampler: "object | None" = None
    #: the live plane: the HTTP status server and the time-series
    #: recorder, both stopped by finish AND the flight recorder
    server: "object | None" = None
    series: "object | None" = None
    #: the SLO evaluator watching the series ring: runs whenever the
    #: recorder runs, stopped with the live plane (its final tick sees
    #: the recorder's final sample)
    alerts: "object | None" = None
    #: the launch-ledger baseline taken at creation; ``finish_xprof``
    #: deltas against it
    xprof_base: "dict | None" = None
    #: calibration store: ``calib`` accumulates THIS run (merged into the
    #: file at finish), ``calib_prior`` is the loaded history consumers
    #: read (the planner, auto-B); both None without ``calib_dir`` or when
    #: the store refused to load
    calib: "object | None" = None
    calib_prior: "object | None" = None
    #: the job plan, solved in ``recording`` before the body runs and
    #: scored in ``finish``; None with ``plan='off'``
    plan: "dict | None" = None
    #: the data-plane audit, created by :meth:`ensure_dataplane`; stays
    #: None when ``config.data_audit`` is off
    dataplane: "object | None" = None
    dataplane_enabled: bool = True
    #: first-phase latch for the ``attrib/pre_phase_ms`` stamp
    _setup_stamped: bool = False
    #: the end of the envelope's set-up (tracer clock) and the thread it
    #: ran on, stamped by :meth:`recording`; ``finish`` records the
    #: ``obs/setup`` span from them
    _setup_end: "float | None" = None
    _setup_tid: "int | None" = None

    @classmethod
    def from_config(cls, config, process: int = 0,
                    n_processes: int = 1) -> "Obs":
        """Build the bundle a job's config asks for (JAX ``Obs.from_config``
        :194): the launch-ledger window opens; the device sampler starts
        when asked for or when the live plane runs; the time series, the
        SLO evaluator and the HTTP plane start with ``obs_sample_s`` /
        ``obs_port``; and ``calib_dir``'s store loads (recording
        ``calib/store_runs``, or ``calib/load_refused`` when it refuses).
        ``trace_out='-'`` collects the trace for ``result.trace`` without
        writing a file, as ``trace_dir`` alone does (whose device trace
        holds the spans as profiler ranges).

        Multi-process jobs pass their slot: progress lines are prefixed
        with the process id and printed by process 0 only (the processes
        advance in lockstep; ``MOXT_PROGRESS_ALL_PROCS=1`` prints every
        process's)."""
        # the tracer first: its epoch opens the envelope's ``obs/setup``.
        # A trace_dir job traces too: its spans are then profiler ranges
        # in the device trace
        tracer = Tracer(enabled=bool(config.trace_out or config.trace_dir))
        live = config.obs_port >= 0 or config.obs_sample_s > 0
        sample_s = config.obs_sample_s
        if live and sample_s <= 0:
            sample_s = 1.0  # serving implies sampling: /series must work
        hb = None
        if config.progress or live:
            total = None
            try:
                total = os.path.getsize(config.input_path)
            except OSError:
                pass
            # the live plane needs the heartbeat's row/phase/ETA tracking
            # for /status even when progress lines are off: a silent
            # heartbeat tracks the same and emits nothing
            silent = not config.progress
            emit = None
            if n_processes > 1 and not silent:
                if process != 0 and not os.environ.get(
                        "MOXT_PROGRESS_ALL_PROCS"):
                    silent = True  # lockstep: P copies of a line are noise
                else:
                    emit = (lambda line, _p=process:
                            _log.info("[proc %d] %s", _p, line))
            hb = Heartbeat(total_bytes=total,
                           interval_s=config.progress_interval_s,
                           emit=(lambda line: None) if silent else emit)
            hb.silent = silent
        obs = cls(registry=MetricsRegistry(), tracer=tracer,
                  heartbeat=hb, process=process, n_processes=n_processes,
                  dataplane_enabled=bool(config.data_audit))
        obs.xprof_base = _compile.LEDGER.activate(obs)
        hbm_s = config.hbm_sample_s
        if live and hbm_s <= 0:
            # the live plane implies the device sampler: /status and the
            # series carry hbm/live_bytes at the sample cadence
            hbm_s = sample_s
        if hbm_s > 0 or config.stall_warn_factor > 0:
            obs.sampler = xprof.DeviceSampler(
                obs, interval_s=hbm_s,
                stall_factor=config.stall_warn_factor)
            obs.sampler.start()
        if sample_s > 0:
            # MOXT_SERIES_CAPACITY: a test hook for ring-wraparound
            # coverage (a tiny ring wraps in seconds)
            try:
                cap = int(os.environ.get("MOXT_SERIES_CAPACITY", "")
                          or DEFAULT_CAPACITY)
            except ValueError:
                cap = DEFAULT_CAPACITY
            obs.series = TimeSeriesRecorder(obs.registry,
                                            interval_s=sample_s,
                                            capacity=cap,
                                            heartbeat=obs.heartbeat,
                                            obs=obs)
            obs.series.start()
            # the SLO plane rides the series ring: default rules plus
            # slo_rules; incident bundles land under incident_dir
            # (default: crash_dir)
            obs.alerts = SloEvaluator(
                obs, load_rules(config.slo_rules), config=config,
                interval_s=sample_s,
                incident_dir=config.incident_dir or config.crash_dir)
            obs.alerts.start()
        if config.obs_port >= 0:
            obs.server = ObsServer(
                obs, config, serve_port_for_process(config.obs_port,
                                                    obs.process))
            obs.server.start()
        if config.calib_dir:
            path = os.path.join(config.calib_dir, _calib.CALIB_FILE)
            try:
                # the history loads read-only for its consumers; the run
                # accumulates into a fresh store, so the finish-time merge
                # never counts the history twice
                obs.calib_prior = _calib.CalibStore.load(path)
                obs.calib = _calib.CalibStore(path=path)
                obs.registry.set("calib/store_runs",
                                 obs.calib_prior.doc.get("runs", 0))
            except _calib.CalibMismatch as e:
                # stale or torn evidence never merges: the run proceeds
                # uncalibrated, loudly
                obs.registry.set("calib/load_refused", 1)
                _log.warning("calibration store refused to load: %s", e)
        return obs

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

    def knob(self, name: str, fallback):
        """The planner-effective value of a tunable knob: the plan's value
        when a plan exists, else ``fallback`` (the config's).  Drivers
        read knobs here so a solved value applies without mutating the
        config."""
        row = ((self.plan or {}).get("knobs") or {}).get(name)
        if row is not None and row.get("value") is not None:
            return row["value"]
        return fallback

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

    def step(self, name: str, **attrs) -> "_Step":
        """One timed step of a driver loop: the span ``name`` when the
        job is traced, and in every run the counter ``<name>_ms``, the
        step's wall summed over the job."""
        return _Step(self, name, attrs)

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

    def stop_live(self) -> None:
        """Quiesce the live plane (JAX ``Obs.stop_live`` :444): stop the
        HTTP server (no scrape may observe a half-finished export), the
        time-series recorder (which takes its final sample) and then the
        SLO evaluator (whose final tick sees that sample, so a condition
        that cleared at the very end still resolves).  Idempotent; called
        by ``finish`` AND the flight recorder."""
        if self.server is not None:
            self.server.stop()
        if self.series is not None:
            self.series.stop()
        if self.alerts is not None:
            self.alerts.stop()

    def finish_xprof(self) -> dict | None:
        """Close the job's launch-ledger window: stop the sampler, resolve
        the job's pending device-time samples (CUDA event pairs), fold the
        per-job delta into ``compile/*`` / ``xprof/*`` gauges and return
        the structured report (None on a second call)."""
        if self.sampler is not None:
            self.sampler.stop()
            self.sampler = None
        _compile.LEDGER.resolve(self)
        local = _compile.LEDGER.deactivate(self)
        base, self.xprof_base = self.xprof_base, None
        if base is None:
            return None
        report = xprof.job_report(_compile.LEDGER.job_delta(base, local))
        for k, v in xprof.flatten_report(report).items():
            self.registry.set(k, v)
        return report

    def _merge_calibration(self, xprof_report: dict | None,
                           workload: str | None, corpus_bytes: float,
                           attrib_doc: dict | None) -> None:
        """Fold this run's program rows and its workload's wall
        attribution into the calibration store and merge it into the
        file.  A refusal records ``calib/merge_refused``; the job's result
        never depends on the store."""
        if self.calib is None:
            return
        try:
            ident = _calib.run_identity(self.n_processes)
            touched = self.calib.accumulate_run(
                ident, self.registry.comms_table(), xprof_report,
                source="job")
            if workload and workload != "serve":
                touched += self.calib.accumulate_workload(
                    ident, workload, corpus_bytes, attrib_doc)
            if touched:
                self.calib.save_merged()
                self.registry.set("calib/rows_merged", touched)
                self.registry.set("calib/runs",
                                  self.calib.doc.get("runs", 0))
        except _calib.CalibMismatch as e:
            self.registry.set("calib/merge_refused", 1)
            _log.warning("calibration store refused the merge: %s", e)
        except OSError as e:
            _log.warning("calibration merge failed: %s", e)

    def finish(self, config, workload: str | None = None
               ) -> tuple[dict, list | None]:
        """End-of-job hook: the live plane stops, then the launch-ledger
        report, the wall attribution, the critical path, the plan's score,
        the calibration merge, the data-plane audit, final memory
        watermarks, the ``metrics_out`` and ``trace_out`` exports
        (stamped, with the ``series`` and ``alerts`` sections when the
        live plane ran), the ledger append (JAX :606-631), and the
        ``(summary, trace_events)`` pair the result carries.
        ``trace_events`` is None when tracing was off.  The resident
        server's own bundle (workload ``serve``) has no job wall to
        decompose, so its finish publishes no critical path.

        The work up to the exports is the span ``obs/finish``; with the
        set-up (``obs/setup``: ``from_config`` and the plan solve of
        :meth:`recording`) it is the counter ``obs/envelope_ms``, the
        instrumentation's own share of the job's wall, counted before
        the summary is taken."""
        t_finish = self.tracer._clock()
        with self.tracer.span("obs/finish"):
            self.stop_live()
            xprof_report = self.finish_xprof()
            attrib_doc = attrib.finalize(
                self, xprof_report,
                max(time.time() - self.tracer.wall_start, 1e-9))
            critpath_doc = None
            if workload != "serve":
                critpath_doc = critpath.degenerate_from_attrib(
                    attrib_doc, process=self.process)
                critpath.publish(self.registry, critpath_doc)
            if self.plan is not None:
                _plan.finalize(self, self.plan, attrib_doc)
            corpus_bytes = 0.0
            try:
                corpus_bytes = float(os.path.getsize(config.input_path))
            except OSError:
                pass
            self._merge_calibration(xprof_report, workload, corpus_bytes,
                                    attrib_doc)
            data_doc = self.finish_dataplane()
            sample_host_memory(self.registry)
            sample_device_memory(self.registry)
            if self.heartbeat is not None:
                self.heartbeat.final_beat()
            meta = self.stamp(config, workload)
        envelope_ms = (self.tracer._clock() - t_finish) * 1e3
        if self._setup_end is not None:
            self.tracer.record_span("obs/setup", self.tracer._epoch,
                                    self._setup_end, tid=self._setup_tid)
            envelope_ms += (self._setup_end - self.tracer._epoch) * 1e3
        self.registry.count("obs/envelope_ms", envelope_ms)
        summary = self.registry.summary()
        if config.metrics_out:
            doc = dict(self.registry.to_dict(), meta=meta)
            doc["attrib"] = attrib_doc
            if self.plan is not None:
                doc["plan"] = self.plan
            if critpath_doc is not None:
                doc["critpath"] = critpath_doc
            if data_doc is not None:
                doc["data"] = data_doc
            if xprof_report is not None:
                doc["xprof"] = xprof_report
            if self.series is not None:
                doc["series"] = self.series.export()
            if self.alerts is not None:
                doc["alerts"] = self.alerts.export()
            write_json_atomic(config.metrics_out, doc)
        trace = self.tracer.chrome_trace() if self.tracer.enabled else None
        if trace is not None:
            trace.insert(0, {"name": "moxt_meta", "ph": "M",
                             "pid": self.tracer._pid, "tid": 0,
                             "args": meta})
            if config.trace_out and config.trace_out != "-":
                write_json_atomic(config.trace_out, trace, indent=None)
        if config.ledger_dir:
            extra: dict = {}
            if self.plan is not None:
                # the full plan rides the entry; the flat plan/* gauges
                # are already in the summary the gate compares
                extra["plan"] = self.plan
            comms = self.registry.comms_table()
            if comms:
                extra["comms"] = comms
            if data_doc is not None:
                extra["data"] = dataplane_ledger_section(data_doc)
            if self.alerts is not None and (self.alerts.fired_total
                                            or self.alerts.resolved_total):
                extra["alerts"] = self.alerts.timeline_doc()
            ledger.append(config.ledger_dir, ledger.build_entry(
                config, workload or "?", summary,
                n_processes=self.n_processes, extra=extra or None))
        return summary, trace

    @contextlib.contextmanager
    def recording(self, config, workload: str | None = None):
        """Crash-safe envelope for a job body: on ANY exception the flight
        recorder closes open spans, flushes the partial metrics/trace to
        their configured paths and dumps a post-mortem bundle under
        ``config.crash_dir``; then the exception propagates unchanged.
        Also binds this bundle as the context's current job
        (:mod:`map_oxidize_tpu_torch.obs.context`).

        Unless ``config.plan`` is ``'off'``, the job plan is solved first
        (``runtime/planner.py``) and its ``plan/*`` gauges published;
        planning is evidence, never a reason to fail the job.  The plan's
        end closes the envelope's set-up (``obs/setup``, from the
        tracer's epoch in ``from_config``)."""
        self.workload = workload
        if (self.plan is None and workload and workload != "serve"
                and config.plan != "off"):
            from map_oxidize_tpu_torch.runtime import planner as _planner

            try:
                self.plan = _planner.build_plan(
                    config, workload, calib_prior=self.calib_prior,
                    n_processes=self.n_processes)
                _plan.publish(self.registry, self.plan)
            except Exception as e:
                _log.warning("job planning failed: %s", e)
        if self._setup_end is None:
            self._setup_end = self.tracer._clock()
            self._setup_tid = threading.get_ident()
        try:
            with use_obs(self):
                yield self
        except BaseException as exc:
            from map_oxidize_tpu_torch.obs import flight

            flight.record_failure(self, config, exc, workload=workload)
            raise


class _Step:
    """:meth:`Obs.step`.  A traced step's counter reads its span's own two
    clock reads (an ``Obs`` tracer's clock is ``perf_counter``); an
    untraced one reads the clock twice itself."""

    __slots__ = ("_registry", "_counter", "_span", "_t0")

    def __init__(self, obs: Obs, name: str, attrs: dict):
        self._registry = obs.registry
        self._counter = f"{name}_ms"
        self._span = obs.tracer.span(name, **attrs)

    def __enter__(self):
        if self._span is NULL_SPAN:
            self._t0 = time.perf_counter()
        return self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        span = self._span
        if span is NULL_SPAN:
            dt = time.perf_counter() - self._t0
        else:
            span.__exit__(*exc)
            dt = span._t1 - span._t0
        self._registry.count(self._counter, dt * 1e3)
        return False


def observe_device_wait(t0: float) -> float:
    """A blocking device-to-host fetch started at ``t0`` (its wait for the
    device chain that produced the data, plus the copy) into the current
    job's ``device/compute_ms``: the consumer-visible device time of the
    attribution.  Only fetches that block anyway are timed; no sync is
    added.  On the card these fetches are all of ``device/compute_ms``:
    the launch ledger's sampled device time comes from CUDA event pairs
    and waits for nothing.  Returns the wait in ms, so that a caller's own
    counter of the same interval takes the same two clock reads; records
    nothing outside a job."""
    ms = (time.perf_counter() - t0) * 1e3
    obs = current_obs()
    if obs is not None:
        obs.registry.observe("device/compute_ms", ms)
    return ms


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
