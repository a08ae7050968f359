"""Live telemetry HTTP plane: ``/metrics``, ``/status``, ``/series``.  A
copy of the JAX package's ``obs/serve.py`` (``build_healthz`` :95,
``sanitize_metric_name`` :124, ``prometheus_text`` :170, ``build_status``
:257, ``ObsServer`` :621, ``serve_port_for_process`` :717).

``obs_port`` (``--obs-port``) starts one stdlib ``ThreadingHTTPServer``
per job (0 = ephemeral, the bound port is logged as ``[obs] serving
...``), live for the duration of the job and shut down by ``Obs.finish``
*and* the flight recorder:

* ``GET /metrics`` — the registry in Prometheus text exposition format
  (names sanitized to the Prometheus charset, counters/gauges typed,
  histograms as summary quantiles plus cumulative buckets where kept);
* ``GET /status``  — one JSON document: current phase, rows/sec and ETA
  from the heartbeat, the per-program compile/roofline table computed live
  from the launch ledger, device-memory watermarks, the live wall
  attribution, open span stacks and the (empty) comms table;
* ``GET /series``  — the time-series ring
  (:mod:`map_oxidize_tpu_torch.obs.timeseries`) as aligned value lists;
* ``GET /alerts``  — the SLO plane (:mod:`map_oxidize_tpu_torch.obs.slo`):
  firing and recently-resolved alerts, per-rule state and the bounded
  transition timeline (``moxt-alerts-v1``);
* ``GET /healthz`` — the cheap liveness probe (``moxt-healthz-v1``:
  version, uptime, phase, job counts);
* ``POST /profile`` — one bounded deep capture
  (:func:`map_oxidize_tpu_torch.obs.profiler.capture`).

When a resident job service (:mod:`map_oxidize_tpu_torch.serve`) attaches
its scheduler, the SAME server also exposes the job plane — one port, one
process:

* ``GET /jobs``            — the job table (queued/running/done, queue
  depth, the admission snapshot, cached corpora);
* ``GET /jobs/<id>``       — one job's full record (live phase/rows/sec
  and per-job compile deltas while running; the flat metrics summary
  once finished);
* ``POST /jobs``           — submit (JSON body: ``workload``, ``input``,
  optional ``config`` overrides / ``output`` / ``deadline_s`` /
  ``est_hbm_bytes``); malformed requests 400, world-state refusals
  (queue full, oversized, draining) return a ``rejected`` job record;
* ``POST /jobs/<id>/cancel`` — queue-cancel or cooperative running-job
  cancellation;
* ``POST /shutdown``       — graceful drain request (body
  ``{"drain": false}`` for immediate cancellation); the server's main
  loop performs the teardown.

Every read is a snapshot built under the registry's lock, so concurrent
scrapes during a hot feed loop are safe; nothing here launches device
work, so the telemetry plane cannot cause a compile.  ``serve_port_for_
process`` keeps the JAX package's per-process port offset for the
multi-process runs to come.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

STATUS_SCHEMA = "moxt-status-v1"
HEALTHZ_SCHEMA = "moxt-healthz-v1"
PORT_RECORD_SCHEMA = "moxt-obs-port-v1"

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def default_obs_spool() -> str | None:
    """The well-known port-record spool the fleet collector (``obs
    fleet``, ROADMAP A12c) scans when no targets are given:
    ``$MOXT_OBS_SPOOL`` if set (``none`` disables publishing), else a
    per-user directory under the system tempdir — stable across
    processes, so a 2-process Gloo run and the ``obs fleet`` watching it
    agree on the location without any flag."""
    env = os.environ.get("MOXT_OBS_SPOOL")
    if env:
        return None if env == "none" else env
    import tempfile

    uid = getattr(os, "getuid", lambda: 0)()
    return os.path.join(tempfile.gettempdir(), f"moxt-obs-spool-{uid}")


def build_healthz(srv) -> dict:
    """``GET /healthz``: the cheap liveness document — version, uptime,
    phase, and job counts, with NONE of the ``/status`` render (no xprof
    join, no attribution pass, no comms table).  This is what the fleet
    collector and the future front-door router probe at their poll
    cadence; the full ``/status`` stays the on-demand deep read."""
    from map_oxidize_tpu_torch import __version__

    obs = srv.obs
    now = time.time()
    phase = getattr(obs, "current_phase", None)
    hb = getattr(obs, "heartbeat", None)
    if hb is not None and hb.phase:
        phase = hb.phase
    doc = {
        "schema": HEALTHZ_SCHEMA,
        "version": __version__,
        "t_unix_s": round(now, 3),
        "uptime_s": round(max(now - obs.tracer.wall_start, 0.0), 3),
        "phase": phase,
        "workload": getattr(obs, "workload", None),
        "process": obs.process,
        "n_processes": obs.n_processes,
    }
    if srv.scheduler is not None:
        doc["jobs"] = srv.scheduler.health_doc()
    return doc


def sanitize_metric_name(name: str) -> str:
    """Prometheus metric-name charset: ``[a-zA-Z_:][a-zA-Z0-9_:]*``.
    Slashes, +, - and friends become underscores; a leading digit gets a
    prefix underscore.  Prefixed ``moxt_`` so scraped jobs namespace
    cleanly next to other exporters."""
    s = _PROM_BAD.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return f"moxt_{s}"


def sanitized_export_names(entries, cache: dict | None = None,
                           used: set | None = None) -> dict:
    """Collision-guarded sanitization: the flattening is lossy
    (``comms/a/b`` and ``comms/a_b`` both sanitize to
    ``moxt_comms_a_b``), and two registry keys silently exporting as ONE
    Prometheus series would corrupt every query over it.  ``entries``
    is an iterable of ``(kind, name)`` registry keys; the first taker
    (deterministic: sorted by name then kind among the NEW keys of one
    call) keeps the clean sanitized name, colliders get a stable
    ``_x<hash>`` suffix derived from their ORIGINAL key.

    ``cache``/``used`` make the assignment STICKY across calls (the
    registry-lifetime maps ``prometheus_text`` passes): registry keys
    are created lazily mid-run, and a later-created colliding key must
    extend the mapping, never rename — an already-exported Prometheus
    series keeps its name and identity on every subsequent scrape."""
    import hashlib

    cache = {} if cache is None else cache
    used = set() if used is None else used
    for kind, name in sorted(set(entries), key=lambda e: (e[1], e[0])):
        if (kind, name) in cache:
            continue
        m = sanitize_metric_name(name)
        if m in used:
            digest = hashlib.sha1(f"{kind}:{name}".encode()).hexdigest()
            n = 6
            while f"{m}_x{digest[:n]}" in used and n < len(digest):
                n += 1
            m = f"{m}_x{digest[:n]}"
        used.add(m)
        cache[(kind, name)] = m
    return cache


def prometheus_text(registry, extra_labels: dict | None = None) -> str:
    """The registry in Prometheus text exposition format (v0.0.4):
    counters as ``counter``, gauges as ``gauge``, phase wall-clocks as a
    labeled ``moxt_phase_seconds`` gauge, histograms as summary
    quantiles plus ``_count``/``_sum``."""
    def _num(v) -> str:
        # full-precision exposition values: :g's 6 significant digits
        # silently round large counters (byte totals, ms sums) — a
        # scraper must read back exactly what the registry holds
        return f"{float(v):.12g}"

    labels = ""
    if extra_labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(
            extra_labels.items()))
        labels = "{" + inner + "}"

    def _label(base: str, more: dict | None = None) -> str:
        pairs = dict(extra_labels or {})
        if more:
            pairs.update(more)
        if not pairs:
            return base
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(pairs.items()))
        return base + "{" + inner + "}"

    with registry._lock:
        phases = dict(registry.phases)
        counters = dict(registry.counters)
        gauges = {k: v for k, v in registry.gauges.items()
                  if isinstance(v, (int, float))
                  and not isinstance(v, bool)}
        hists = {k: (h.count, h.total, h.quantile(0.5), h.quantile(0.95),
                     h.max, h.cumulative_buckets())
                 for k, h in registry.histograms.items()}
    # collision-guarded name map for everything this scrape exports —
    # bucketed histograms claim their `<name>_hist` spelling too, so the
    # histogram-typed family can never shadow another metric.  The map
    # is STICKY on the registry: keys created later never rename (or
    # steal the name of) a series an earlier scrape already exported
    entries = ([("counter", n) for n in counters]
               + [("gauge", n) for n in gauges]
               + [("hist", n) for n in hists]
               + [("hist", f"{n}_hist") for n, row in hists.items()
                  if row[5] is not None])
    with registry._lock:
        names = dict(sanitized_export_names(
            entries, cache=registry._prom_names,
            used=registry._prom_used))
    lines: list[str] = []
    if phases:
        lines.append("# TYPE moxt_phase_seconds gauge")
        for name, v in sorted(phases.items()):
            lines.append(
                f'{_label("moxt_phase_seconds", {"phase": name})} {v:.6f}')
    for name, v in sorted(counters.items()):
        m = names[("counter", name)]
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{labels} {_num(v)}")
    for name, v in sorted(gauges.items()):
        m = names[("gauge", name)]
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{labels} {_num(v)}")
    for name, (count, total, p50, p95, mx, buckets) in sorted(
            hists.items()):
        m = names[("hist", name)]
        lines.append(f"# TYPE {m} summary")
        for q, v in (("0.5", p50), ("0.95", p95), ("1", mx)):
            if v is not None:
                lines.append(f'{_label(m, {"quantile": q})} {_num(v)}')
        lines.append(f"{m}_count{labels} {_num(count)}")
        lines.append(f"{m}_sum{labels} {_num(total)}")
        if buckets is not None:
            # the REAL cumulative-bucket histogram, next to the summary
            # under a distinct `_hist` family — stock PromQL
            # histogram_quantile()/burn-rate queries work on it
            hm = names[("hist", f"{name}_hist")]
            lines.append(f"# TYPE {hm} histogram")
            for le, acc in buckets:
                le_s = "+Inf" if le == float("inf") else f"{le:g}"
                lines.append(
                    f'{_label(hm + "_bucket", {"le": le_s})} {_num(acc)}')
            lines.append(f"{hm}_count{labels} {_num(count)}")
            lines.append(f"{hm}_sum{labels} {_num(total)}")
    return "\n".join(lines) + "\n"


def build_status(obs, config, workload: str | None = None) -> dict:
    """The ``/status`` JSON document, computed live from the job's obs
    bundle (the JAX key set).  ``comms`` is the table of collective rows
    the sharded engines record; the port runs none yet (ROADMAP A7), so
    the key is kept and the list is empty."""
    now = time.time()
    elapsed = max(now - obs.tracer.wall_start, 1e-9)
    workload = workload if workload is not None else getattr(
        obs, "workload", None)
    doc: dict = {
        "schema": STATUS_SCHEMA,
        "meta": obs.stamp(config, workload),
        "t_unix_s": round(now, 3),
        "elapsed_s": round(elapsed, 3),
        "phase": getattr(obs, "current_phase", None),
    }
    hb = obs.heartbeat
    if hb is not None:
        doc["phase"] = hb.phase or doc["phase"]
        frac = hb._frac()
        progress = {
            "rows": hb.rows,
            "rows_per_sec": round(hb.rows / elapsed, 1),
            "bytes_done": hb.bytes_done,
        }
        if frac is not None:
            progress["fraction"] = round(frac, 4)
            if 0 < frac < 1:
                progress["eta_s"] = round(elapsed * (1 - frac) / frac, 1)
        if hb.hbm_bytes is not None:
            progress["hbm_bytes"] = hb.hbm_bytes
        doc["progress"] = progress
    # live per-program compile/MFU table: the same join Obs.finish runs,
    # against the job's live overlay in the compile ledger
    if obs.xprof_base is not None:
        from map_oxidize_tpu_torch.obs import compile as _compile
        from map_oxidize_tpu_torch.obs import xprof

        doc["xprof"] = xprof.job_report(_compile.LEDGER.job_delta(
            obs.xprof_base, _compile.LEDGER.overlay(obs)))
    with obs.registry._lock:
        doc["hbm"] = {k: v for k, v in obs.registry.gauges.items()
                      if k.startswith(("hbm/", "mem/"))}
        doc["counters"] = {
            k: v for k, v in obs.registry.counters.items()
            if k.startswith(("heartbeat/", "stall", "pipeline/"))}
        # active shuffle transport + live spill/demotion evidence (the
        # transport is a per-job fact — collect-engine jobs set it)
        transport = obs.registry.gauges.get("shuffle/transport")
        spill = {k: v for k, v in obs.registry.counters.items()
                 if k.startswith(("spill/", "demote/", "shuffle/push_",
                                  "shuffle/remote_"))}
        if transport is not None or spill:
            from map_oxidize_tpu_torch.shuffle.base import TRANSPORTS

            doc["shuffle"] = dict(spill, transport=transport,
                                  transports=list(TRANSPORTS))
    # the comms table: rows of the collectives a sharded engine runs; the
    # port has no sharded engine yet, so the key is kept and the table is
    # empty
    doc["comms"] = []
    # live wall attribution: the same decomposition the obs where CLI
    # renders post-hoc, computed against the running overlay.  The
    # resident SERVER's own bundle is skipped — it idles between jobs,
    # so "job wall" is meaningless there (each job attributes itself)
    if workload != "serve":
        try:
            from map_oxidize_tpu_torch.obs import attrib

            doc["attrib"] = attrib.compute(obs)
        except Exception:  # a decomposition bug must not break /status
            pass
    # the causal headline (obs top's one-line "bound by" panel): the
    # critpath/* gauges land post-merge (distributed proc 0) or at
    # finish (single process) — archived /status snapshots carry them,
    # so the fleet post-mortem readers can answer "what bounded it"
    cp = {k[len("critpath/"):]: v
          for k, v in obs.registry.gauges.items()
          if k.startswith("critpath/")}
    if cp:
        doc["critpath"] = cp
    # the plan observatory document: what the planner promised before
    # the job ran (knobs + provenance + predicted wall) and — once the
    # job finishes — what actually happened.  /status snapshots of a
    # running job show the promise; archived ones show the verdict
    if getattr(obs, "plan", None):
        doc["plan"] = obs.plan
    # the calibration plane: store warmth (calib/store_runs — 0 on a
    # restarted server with a wiped store), coverage of the chooser's
    # needed cells, merge/load refusals, and the selection the planner
    # made (doc["plan"]["exchange"] carries the full decision)
    cal = {k[len("calib/"):]: v
           for k, v in obs.registry.gauges.items()
           if k.startswith("calib/")}
    if cal:
        doc["calib"] = cal
    # the data-plane headline (conservation, skew, reduction): either
    # the live audit mid-run, or the published data/* gauges post-finish
    dp = getattr(obs, "dataplane", None)
    if dp is not None:
        try:
            d = dp.doc()
            doc["data"] = {
                "partitions": d["partitions"],
                "rows_in": d["reduction"]["rows_in"],
                "imbalance_factor": d["skew"]["imbalance_factor"],
                "reduction_ratio": d["reduction"]["ratio"],
                "conservation_violations":
                    len(d["conservation"]["violations"]),
            }
        except Exception:  # an audit bug must not break /status
            pass
    else:
        dg = {k[len("data/"):]: v
              for k, v in obs.registry.gauges.items()
              if k.startswith("data/")}
        if dg:
            doc["data"] = dg
    # open span stacks (what the job is doing RIGHT NOW), when tracing
    if obs.tracer.enabled:
        stacks = []
        with obs.tracer._lock:
            for _tid, stack in obs.tracer._stacks:
                if stack:
                    stacks.append(" > ".join(s.name for s in stack))
        doc["open_spans"] = stacks
    if obs.n_processes > 1:
        doc["process"] = obs.process
        doc["n_processes"] = obs.n_processes
        if obs.process == 0:
            doc["aggregate"] = _aggregate(obs, elapsed)
    return doc


def _aggregate(obs, elapsed: float) -> dict:
    """Process 0's skew-aware global estimate.  Chunks partition
    round-robin and processes advance in lockstep, so process 0's local
    rate times P estimates the global rate; the honesty bound on that
    symmetry assumption is the measured collective-wait fraction — the
    share of wall this process spent blocked on the slowest participant
    (``dist/flag_wait_ms``).  A high wait fraction means the estimate
    leans on a straggler-gated denominator and global progress is
    whatever the straggler allows."""
    P = obs.n_processes
    agg: dict = {"n_processes": P, "method": "lockstep-symmetric-estimate"}
    hb = obs.heartbeat
    if hb is not None:
        agg["est_rows_total"] = hb.rows * P
        agg["est_rows_per_sec"] = round(hb.rows * P / elapsed, 1)
    with obs.registry._lock:
        h = obs.registry.histograms.get("dist/flag_wait_ms")
        wait_s = (h.total / 1e3) if h is not None else 0.0
        rounds = h.count if h is not None else 0
    agg["collective_wait_s"] = round(wait_s, 3)
    agg["collective_rounds"] = rounds
    agg["collective_wait_frac"] = round(min(wait_s / elapsed, 1.0), 4)
    return agg


class _Handler(BaseHTTPRequestHandler):
    """GET-only; the obs bundle rides on the server object."""

    server_version = "moxt-obs"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        srv = self.server
        path = self.path.split("?", 1)[0]
        try:
            if path == "/":
                eps = ["/healthz", "/metrics", "/status", "/series",
                       "/alerts", "POST /profile"]
                if srv.scheduler is not None:
                    eps += ["/jobs", "/jobs/<id>"]
                self._json({"endpoints": eps, "schema": STATUS_SCHEMA})
            elif path == "/healthz":
                self._json(build_healthz(srv))
            elif path == "/alerts":
                ev = getattr(srv.obs, "alerts", None)
                if ev is None:
                    self._json({"error": "SLO evaluator not running "
                                         "(needs the time-series "
                                         "recorder: --obs-port or "
                                         "--obs-sample-interval)"},
                               code=404)
                else:
                    self._json(ev.export())
            elif path == "/jobs":
                if srv.scheduler is None:
                    self._json({"error": "no job scheduler attached "
                                         "(not a resident job server)"},
                               code=404)
                else:
                    self._json(srv.scheduler.jobs_doc())
            elif path.startswith("/jobs/"):
                if srv.scheduler is None:
                    self._json({"error": "no job scheduler attached"},
                               code=404)
                else:
                    doc = srv.scheduler.job_doc(path[len("/jobs/"):])
                    if doc is None:
                        self._json({"error": f"unknown job {path!r}"},
                                   code=404)
                    else:
                        self._json(doc)
            elif path == "/metrics":
                body = prometheus_text(
                    srv.obs.registry,
                    {"process": str(srv.obs.process)}
                    if srv.obs.n_processes > 1 else None)
                self._ok(body.encode(),
                         "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/status":
                self._json(build_status(srv.obs, srv.config))
            elif path == "/series":
                tsr = getattr(srv.obs, "series", None)
                if tsr is None:
                    self._json({"error": "time-series recorder not "
                                         "running (--obs-sample-interval)"},
                               code=404)
                else:
                    self._json(tsr.export())
            else:
                self._json({"error": f"unknown path {path!r}"}, code=404)
        except Exception as e:  # a scrape bug must not kill the job
            try:
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            except Exception:
                pass

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        srv = self.server
        path = self.path.split("?", 1)[0]
        sched = srv.scheduler
        try:
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, OSError) as e:
                self._json({"error": f"bad request body: {e}"}, code=400)
                return
            if path == "/profile":
                # deep-capture on the LIVE process (plain job servers
                # and resident servers alike): blocks for the bounded
                # duration, returns the profile document; a concurrent
                # capture gets 409 (single-capture mutex)
                self._profile(body)
                return
            if sched is None:
                self._json({"error": "no job scheduler attached "
                                     "(not a resident job server)"},
                           code=404)
                return
            if path == "/jobs":
                try:
                    job = sched.submit(
                        workload=body.get("workload", ""),
                        input_path=body.get("input", ""),
                        overrides=body.get("config"),
                        output_path=body.get("output", ""),
                        deadline_s=body.get("deadline_s"),
                        est_hbm_bytes=int(body.get("est_hbm_bytes") or 0),
                    )
                except (ValueError, TypeError) as e:
                    self._json({"error": str(e)}, code=400)
                else:
                    # render the HELD record: a concurrent history prune
                    # must not turn this response into JSON null
                    self._json(sched.job_row(job))
            elif path.startswith("/jobs/") and path.endswith("/cancel"):
                job_id = path[len("/jobs/"):-len("/cancel")]
                job = sched.cancel(
                    job_id,
                    reason=body.get("reason", "cancelled_by_client"))
                if job is None:
                    self._json({"error": f"unknown job {job_id!r}"},
                               code=404)
                else:
                    self._json(sched.job_row(job))
            elif path == "/shutdown":
                sched.request_shutdown(drain=bool(body.get("drain", True)))
                self._json({"ok": True, "draining": True})
            else:
                self._json({"error": f"unknown path {path!r}"}, code=404)
        except Exception as e:  # a request bug must not kill the server
            try:
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            except Exception:
                pass

    def _profile(self, body: dict) -> None:
        """``POST /profile``: one bounded deep capture (device trace +
        host sampling profiler) on this process.  Body (all optional):
        ``duration_s``, ``host_sample_hz``, ``device`` (bool),
        ``label``.  Artifacts land under the job/server profile
        directory (``--profile-dir``; a resident server spools them
        under ``<spool>/profiles``)."""
        from map_oxidize_tpu_torch.obs import profiler

        srv = self.server
        try:
            duration = float(body.get("duration_s",
                                      profiler.DEFAULT_CAPTURE_S))
            hz = float(body.get("host_sample_hz") or getattr(
                srv.config, "host_sample_hz", 0)
                or profiler.DEFAULT_HOST_HZ)
            device = bool(body.get("device", True))
        except (TypeError, ValueError) as e:
            self._json({"error": f"bad /profile body: {e}"}, code=400)
            return
        if not 0 < hz <= 1000:
            # same bound JobConfig.validate enforces on the config-level
            # knob: an unbounded request rate would hot-loop the sampler
            # thread against the very job it is observing
            self._json({"error": "host_sample_hz must be in (0, 1000]"},
                       code=400)
            return
        out_dir = profiler.default_profile_dir(srv.config)
        meta: dict = {}
        if body.get("label"):
            meta["label"] = str(body["label"])[:128]
        if srv.scheduler is not None:
            # a resident server's capture is process-wide; record which
            # jobs were live so the profile joins back to them
            try:
                meta["running_jobs"] = sorted(srv.scheduler._running)
            except Exception:
                pass
        try:
            doc = profiler.capture(
                out_dir, duration_s=duration, host_sample_hz=hz,
                device=device, obs=srv.obs, extra_meta=meta or None)
        except profiler.CaptureBusy as e:
            self._json({"error": str(e)}, code=409)
        except ValueError as e:
            self._json({"error": str(e)}, code=400)
        else:
            self._json(doc)

    def _ok(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, doc: dict, code: int = 200) -> None:
        from map_oxidize_tpu_torch.obs import _json_default

        body = json.dumps(doc, default=_json_default).encode()
        self._ok(body, "application/json", code)

    def log_message(self, fmt, *args):  # route access logs to debug
        _log.debug("obs-serve: " + fmt, *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # set by ObsServer after construction
    obs = None
    config = None
    #: resident job service hookup (None for plain per-job telemetry
    #: servers — the /jobs plane then 404s)
    scheduler = None


class ObsServer:
    """One job's telemetry server: a daemon ``serve_forever`` thread over
    a :class:`ThreadingHTTPServer` (each scrape handled on its own
    thread).  ``port=0`` binds an ephemeral port; the bound port is on
    ``.port`` and in the ``[obs] serving`` log line."""

    def __init__(self, obs, config, port: int, host: str = "127.0.0.1",
                 scheduler=None):
        self._httpd = _Server((host, port), _Handler)
        self._httpd.obs = obs
        self._httpd.config = config
        self._httpd.scheduler = scheduler
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-serve")
        self._stopped = False
        self._spool_record: str | None = None

    def start(self) -> None:
        self._thread.start()
        _log.info("[obs] serving live telemetry on %s "
                  "(/metrics /status /series)", self.url)
        portfile = os.environ.get("MOXT_OBS_PORT_FILE")
        if portfile:
            # machine-readable port discovery for harnesses scraping an
            # ephemeral-port job (smoke scripts, tests): one
            # appended "<process> <port>" line per serving process
            try:
                fd = os.open(portfile,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                try:
                    os.write(fd, f"{self._httpd.obs.process} "
                                 f"{self.port}\n".encode())
                finally:
                    os.close(fd)
            except OSError as e:  # discovery is best-effort
                _log.warning("cannot write MOXT_OBS_PORT_FILE %s: %s",
                             portfile, e)
        self._publish_spool_record()

    def _publish_spool_record(self) -> None:
        """Drop a ``moxt-obs-port-v1`` record in the well-known spool so
        ``obs fleet`` discovers this process with no flags: every process
        of a distributed run publishes its own slot, so a 2-process Gloo
        job appears as two targets.  Removed on clean :meth:`stop`; a
        killed process leaves its record behind with a dead pid, which is
        exactly how the collector tells "exited" from "died" (dead-pid
        records it never watched are garbage-collected at discovery)."""
        spool = (getattr(self._httpd.config, "obs_spool", None)
                 or default_obs_spool())
        if not spool or spool == "none":
            return
        obs = self._httpd.obs
        path = os.path.join(
            spool, f"moxt-obs-{os.getpid()}-p{obs.process}.json")
        try:
            from map_oxidize_tpu_torch import __version__
            from map_oxidize_tpu_torch.obs import write_json_atomic

            os.makedirs(spool, exist_ok=True)
            write_json_atomic(path, {
                "schema": PORT_RECORD_SCHEMA,
                "version": __version__,
                "pid": os.getpid(),
                "process": obs.process,
                "n_processes": obs.n_processes,
                "host": self.host,
                "port": self.port,
                "url": self.url,
                "started_unix_s": round(time.time(), 3),
            })
            self._spool_record = path
        except OSError as e:  # discovery is best-effort
            _log.debug("cannot publish obs port record %s: %s", path, e)

    def stop(self) -> None:
        """Idempotent clean shutdown (called by ``Obs.finish`` AND the
        flight recorder — whichever runs first wins)."""
        if self._stopped:
            return
        self._stopped = True
        if self._spool_record:
            try:
                os.unlink(self._spool_record)
            except OSError:
                pass
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception as e:  # pragma: no cover - defensive
            _log.debug("obs server shutdown: %s", e)


def serve_port_for_process(obs_port: int, process: int) -> int:
    """The port THIS process binds: ephemeral stays ephemeral; a fixed
    port offsets by the process slot so co-hosted processes don't
    collide."""
    return 0 if obs_port == 0 else obs_port + process
