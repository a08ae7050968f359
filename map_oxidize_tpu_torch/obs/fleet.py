"""Fleet observatory: one collector over N obs endpoints.  A copy of the
JAX package's ``obs/fleet.py`` (``SeriesArchive`` :151, ``discover_targets``
:363, ``Target`` :445, ``FleetCollector`` :483, ``correlate_alerts`` :976,
``FleetServer`` :1111) over the port's live plane.  The wire formats are
the JAX package's, so a collector of either package merges the obs servers
of both, and an archive written by one is read by the other.

* :class:`FleetCollector` — a daemon that polls any number of obs
  endpoints (explicit ``--targets``, a ``MOXT_OBS_PORT_FILE``-format
  port file, resident-server spool dirs, and the well-known port-record
  spool every serving process publishes into), merges their ``/healthz``
  + ``/status`` + ``/alerts`` (+ ``/jobs`` on resident servers) into one
  fleet model with per-target freshness tracking.  A dead endpoint
  becomes a ``stale`` row and a fleet alert — never a crash; a
  malformed or version-mismatched payload is refused and counted
  (``fleet/scrape_refused``), never merged.
* the **fleet HTTP plane** (:class:`FleetServer`): fleet ``/metrics``
  (per-target ``{target="host:port"}`` labeled series plus fleet
  aggregates — total rows/sec, max device-memory watermark, summed queue
  depth), fleet ``/status`` (``moxt-fleet-status-v1``), fleet ``/alerts``
  (``moxt-fleet-alerts-v1``) with cross-target correlation — the same
  rule firing on k targets within a window collapses into ONE fleet
  incident naming all k — and ``/series`` over the collector's own ring.
* **fleet SLOs** — the port's :class:`~map_oxidize_tpu_torch.obs.slo.
  SloEvaluator` against the merged fleet series (:data:`FLEET_RULES`:
  any target stale past the window, per-target device memory above 95%
  of its budget, scrape refusals, a cold calibration store).
* :class:`SeriesArchive` — the persistent fleet series store
  (``--archive-dir``, ``moxt-archive-v1``): a bounded ring of JSONL
  segments (never past ``segment_records * max_segments`` samples) plus
  the latest fleet status/alerts/per-target snapshots, so ``obs
  trend/top/where/critpath --archive`` read a run's trajectory after
  every worker process has exited.

Pure host-side work: no torch, no device — the collector runs on a
machine without a card.
"""

from __future__ import annotations

import glob
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from map_oxidize_tpu_torch.obs import Obs, write_json_atomic
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.obs.serve import (
    HEALTHZ_SCHEMA,
    PORT_RECORD_SCHEMA,
    STATUS_SCHEMA,
    default_obs_spool,
    prometheus_text,
    sanitize_metric_name,
)
from map_oxidize_tpu_torch.obs.trace import Tracer
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

FLEET_STATUS_SCHEMA = "moxt-fleet-status-v1"
FLEET_ALERTS_SCHEMA = "moxt-fleet-alerts-v1"
ARCHIVE_SCHEMA = "moxt-archive-v1"

#: correlation lookback: 'fired' timeline events this recent still join
#: an incident bundle even if the per-target alert already resolved
CORRELATE_WINDOW_S = 300.0

#: recently-finished jobs contribute to a resident server's fleet row
#: rate for this long (running jobs report live; a sub-second job would
#: otherwise never register on the load index)
RATE_WINDOW_S = 10.0

#: dead-pid discovery records younger than this are left alone (not
#: added, not deleted): the well-known spool is SHARED, and another
#: collector may still be watching that target — deleting a fresh
#: record would turn its kill-evidence into a phantom clean departure
GC_GRACE_S = 3600.0

#: per-target gauges exported as labeled Prometheus series AND recorded
#: flat (``fleet/target/<label>/<name>``) so the series ring and the
#: fleet SLO globs see them
_TARGET_GAUGES = ("up", "stale", "staleness_s", "rows_per_sec",
                  "hbm_bytes", "queue_depth", "jobs_running",
                  "alerts_firing")

#: built-in fleet-scope SLO rules (the ``--slo-rules`` defaults for the
#: collector's evaluator — extend/replace/tune by name like any rule
#: set).  Calibrated silent on a healthy fleet: staleness only trips
#: after the collector's stale window, the HBM fraction only where a
#: target publishes a budget, refusals only when a payload is rejected.
FLEET_RULES: tuple[dict, ...] = (
    # the collector sets the per-target stale gauge after stale_after_s
    # of failed/refused scrapes; the rule turns it into a firing alert
    # that resolves the tick the target comes back (or departs cleanly)
    {"name": "fleet-target-stale", "metric": "fleet/target/*/stale",
     "kind": "value", "op": ">=", "threshold": 1, "scope": "fleet",
     "severity": "critical",
     "description": "target unreachable (or refusing payloads) past "
                    "the staleness window"},
    # per-target HBM watermark against ITS OWN published admission
    # budget (the gauge only exists where a target reports both, so
    # CPU fleets skip the rule by construction)
    {"name": "fleet-hbm-watermark", "metric": "fleet/target/*/hbm_frac",
     "kind": "value", "op": ">", "threshold": 0.95, "for_s": 5,
     "scope": "fleet", "severity": "critical",
     "description": "a target's live HBM above 95% of its admission "
                    "budget"},
    {"name": "fleet-scrape-refused", "metric": "fleet/scrape_refused",
     "kind": "delta", "op": ">", "threshold": 0, "window_s": 120,
     "scope": "fleet", "severity": "warning",
     "description": "malformed or version-mismatched payloads refused "
                    "at scrape (never merged into the fleet model)"},
    # cold calibration store: a target publishing calib_store_runs == 0
    # is a restarted server with an empty (or wiped) store — its first
    # jobs will run the hard-coded collective defaults.  Info severity:
    # visibility BEFORE the first mispredicted job, not an emergency
    # (the gauge only exists where a target runs with --calib-dir, so
    # uncalibrated fleets skip the rule by construction)
    {"name": "fleet-calib-cold",
     "metric": "fleet/target/*/calib_store_runs",
     "kind": "value", "op": "<=", "threshold": 0, "scope": "fleet",
     "severity": "info",
     "description": "a target's calibration store holds zero merged "
                    "runs (collective chooser will fall back to "
                    "defaults)"},
)


class ArchiveMismatch(ValueError):
    """The on-disk archive's schema/version disagrees with this reader —
    refused, never silently reinterpreted."""


# --- the persistent series archive -----------------------------------------


class SeriesArchive:
    """Bounded on-disk fleet series store (``moxt-archive-v1``).

    Layout under ``root``::

        archive.json          # {"schema": "moxt-archive-v1", bounds...}
        seg-0000000001.jsonl  # one {"t": ts, "v": {name: value}} / line
        seg-0000000002.jsonl  # ...ring: oldest segment pruned past the
        status-latest.json    #    max_segments bound
        alerts-latest.json
        targets-latest.json

    Appends are line-buffered into the current segment; at
    ``segment_records`` lines the writer rolls to the next segment and
    prunes the oldest past ``max_segments`` — the archive holds at most
    ``segment_records * max_segments`` samples at any size, so a
    week-long fleet watch has a fixed disk footprint.  The ``*-latest``
    snapshots are atomic whole-document writes (temp + rename), giving
    ``obs top/where --archive`` a post-mortem view even when every
    producer process is gone."""

    META_FILE = "archive.json"

    def __init__(self, root: str, segment_records: int = 512,
                 max_segments: int = 16):
        if segment_records < 1 or max_segments < 2:
            raise ValueError("archive needs >= 1 record per segment and "
                             ">= 2 segments")
        self.root = root
        self.segment_records = segment_records
        self.max_segments = max_segments
        self._lock = threading.Lock()
        self._seg_index = 0
        self._seg_count = 0
        self._fh = None
        os.makedirs(root, exist_ok=True)
        meta_path = os.path.join(root, self.META_FILE)
        if os.path.exists(meta_path):
            self._read_meta(meta_path)          # refuses on mismatch
            # resume the ring where the previous collector left it
            segs = self._segments()
            if segs:
                self._seg_index = self._seg_num(segs[-1])
                with open(segs[-1]) as f:
                    self._seg_count = sum(1 for _ in f)
        else:
            write_json_atomic(meta_path, {
                "schema": ARCHIVE_SCHEMA,
                "segment_records": segment_records,
                "max_segments": max_segments,
                "created_unix_s": round(time.time(), 3),
            })

    # --- reading ----------------------------------------------------------

    @staticmethod
    def _read_meta(meta_path: str) -> dict:
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise ArchiveMismatch(f"unreadable archive meta "
                                  f"{meta_path!r}: {e}") from e
        if not isinstance(meta, dict) or meta.get("schema") != \
                ARCHIVE_SCHEMA:
            raise ArchiveMismatch(
                f"archive schema mismatch at {meta_path!r}: expected "
                f"{ARCHIVE_SCHEMA!r}, found {meta.get('schema')!r} — "
                "refusing to read (written by an incompatible version?)")
        return meta

    @classmethod
    def samples(cls, root: str) -> list[tuple[float, dict]]:
        """Every surviving ``(unix_ts, {name: value})`` sample, oldest
        first.  Validates the schema first (:class:`ArchiveMismatch` on
        disagreement); torn trailing lines (a collector killed
        mid-append) are skipped, never fatal."""
        cls._read_meta(os.path.join(root, cls.META_FILE))
        out: list[tuple[float, dict]] = []
        for seg in sorted(glob.glob(os.path.join(root, "seg-*.jsonl")),
                          key=cls._seg_num):
            with open(seg) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        out.append((float(rec["t"]), rec["v"]))
                    except (ValueError, KeyError, TypeError):
                        continue        # torn tail of a killed writer
        out.sort(key=lambda s: s[0])
        return out

    @classmethod
    def export(cls, root: str) -> dict:
        """The archive as a ``moxt-series-v1``-shaped document
        (aligned timestamp/value lists) — what the post-mortem readers
        and tests consume."""
        samples = cls.samples(root)
        t = [round(ts, 3) for ts, _v in samples]
        names: dict[str, None] = {}
        for _ts, v in samples:
            for k in v:
                names.setdefault(k)
        return {
            "schema": ARCHIVE_SCHEMA,
            "t_unix_s": t,
            "series": {n: [v.get(n) for _ts, v in samples]
                       for n in names},
        }

    @classmethod
    def latest(cls, root: str, name: str) -> dict | None:
        """One of the ``*-latest.json`` snapshots (``status`` /
        ``alerts`` / ``targets``), or None when absent."""
        cls._read_meta(os.path.join(root, cls.META_FILE))
        try:
            with open(os.path.join(root, f"{name}-latest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # --- writing ----------------------------------------------------------

    @staticmethod
    def _seg_num(path: str) -> int:
        base = os.path.basename(path)
        try:
            return int(base[len("seg-"):-len(".jsonl")])
        except ValueError:
            return 0

    def _segments(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.root, "seg-*.jsonl")),
                      key=self._seg_num)

    def append(self, ts: float, values: dict) -> None:
        """Add one sample to the ring (rolls/prunes segments at the
        bounds).  Values are flushed per append — a killed collector
        loses at most the torn final line."""
        with self._lock:
            if self._fh is None or self._seg_count >= self.segment_records:
                if self._fh is not None:
                    self._fh.close()
                self._seg_index += 1
                self._seg_count = 0
                self._fh = open(os.path.join(
                    self.root, f"seg-{self._seg_index:010d}.jsonl"), "a")
                segs = self._segments()
                for old in segs[:max(0, len(segs) - self.max_segments)]:
                    try:
                        os.unlink(old)
                    except OSError:
                        pass
            self._fh.write(json.dumps(
                {"t": round(ts, 3), "v": values},
                separators=(",", ":")) + "\n")
            self._fh.flush()
            self._seg_count += 1

    def write_latest(self, name: str, doc: dict) -> None:
        write_json_atomic(os.path.join(self.root, f"{name}-latest.json"),
                          doc)

    def doc(self) -> dict:
        """The archive's slice of the fleet status document."""
        with self._lock:
            segs = self._segments()
            return {
                "dir": self.root,
                "segments": len(segs),
                "records_in_segment": self._seg_count,
                "max_records": self.segment_records * self.max_segments,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# --- target discovery -------------------------------------------------------


def _label_of(url: str) -> str:
    """host:port — the stable target label Prometheus series carry."""
    u = url
    for prefix in ("http://", "https://"):
        if u.startswith(prefix):
            u = u[len(prefix):]
    return u.rstrip("/")


def _normalize_url(spec: str) -> str:
    spec = spec.strip().rstrip("/")
    if not spec.startswith(("http://", "https://")):
        spec = "http://" + spec
    return spec


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True                      # EPERM: alive, not ours
    return True


def discover_targets(cfg, known: set[str] | None = None
                     ) -> dict[str, dict]:
    """One discovery sweep: ``{label: {"url", "source", "explicit"}}``
    from every configured source.  ``known`` is the set of labels the
    collector already watches — a well-known-spool record whose pid is
    dead is garbage-collected UNLESS we were watching it (a watched
    target dying without cleanup must surface as *stale*, not silently
    vanish; a record left by some long-gone unrelated run must not
    conjure a phantom target)."""
    known = known or set()
    found: dict[str, dict] = {}

    def _add(url: str, source: str, explicit: bool) -> None:
        url = _normalize_url(url)
        label = _label_of(url)
        if label not in found:
            found[label] = {"url": url, "source": source,
                            "explicit": explicit}

    for t in cfg.targets:
        _add(t, "target", True)
    if cfg.port_file:
        try:
            with open(cfg.port_file) as f:
                for line in f:
                    parts = line.split()
                    # "fleet <port>" lines are a COLLECTOR's own record
                    # (FleetServer appends one to MOXT_OBS_PORT_FILE):
                    # skipped, or a collector sharing the run's port
                    # file would discover itself and refuse its own
                    # fleet-schema payload every sweep
                    if (len(parts) == 2 and parts[1].isdigit()
                            and parts[0] != "fleet"):
                        _add(f"127.0.0.1:{parts[1]}", "portfile", False)
        except OSError:
            pass                         # not written yet: fine
    for spool in cfg.spool_dirs:
        rec = _read_port_record(os.path.join(spool, "obs_port.json"))
        if rec is not None:
            _add(rec["url"], "spool", False)
    discover_dir = cfg.discover_dir or default_obs_spool()
    if discover_dir and discover_dir != "none" \
            and os.path.isdir(discover_dir):
        for path in sorted(glob.glob(os.path.join(discover_dir,
                                                  "moxt-obs-*.json"))):
            rec = _read_port_record(path)
            if rec is None:
                continue
            label = _label_of(rec["url"])
            pid = rec.get("pid")
            if isinstance(pid, int) and not _pid_alive(pid) \
                    and label not in known:
                # a dead record WE never watched: not a target — but
                # only long-dead garbage is deleted (another collector
                # sharing this spool may be watching it, and needs the
                # record to tell "killed" from "exited cleanly")
                try:
                    if time.time() - os.path.getmtime(path) > GC_GRACE_S:
                        os.unlink(path)
                except OSError:
                    pass
                continue
            _add(rec["url"], "discovered", False)
    return found


def _read_port_record(path: str) -> dict | None:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("schema") != \
            PORT_RECORD_SCHEMA or not rec.get("url"):
        return None
    return rec


# --- the collector ----------------------------------------------------------


@dataclass
class Target:
    """One watched endpoint's model cell."""

    label: str
    url: str
    source: str = "target"
    explicit: bool = False
    first_seen_unix_s: float = 0.0
    last_scrape_unix_s: float = 0.0
    #: last successful, schema-valid /status merge (staleness clock)
    last_ok_unix_s: float = 0.0
    up: bool = False
    stale: bool = False
    #: the target's discovery record vanished (a CLEAN exit): excluded
    #: from aggregates and the stale alert resolves — distinct from a
    #: dead endpoint whose record remains, which goes stale instead
    departed: bool = False
    errors: int = 0
    refusals: int = 0
    version: str | None = None
    #: last good documents (kept across failed scrapes: the post-mortem
    #: evidence is the last thing the target SAID, not the failure)
    healthz: dict | None = None
    status: dict | None = None
    alerts: dict | None = None
    jobs: dict | None = None
    last_error: str | None = None

    @property
    def kind(self) -> str:
        wl = (self.status or {}).get("meta", {}).get("workload") \
            if self.status else None
        if wl is None and self.healthz:
            wl = self.healthz.get("workload")
        return "serve" if wl == "serve" else \
            ("job" if wl is not None else "unknown")


class FleetCollector:
    """Polls the target set, maintains the merged fleet model, the fleet
    registry/series ring, the fleet SLO evaluator, and the archive.

    One sweep is :meth:`poll_once` — fully synchronous and clock-
    injectable, so tests drive staleness and alert transitions
    deterministically without the thread; :meth:`start` runs it on a
    daemon loop at ``cfg.poll_interval_s``."""

    def __init__(self, cfg, clock=time.time, http_timeout_s: float = 2.0):
        self.cfg = cfg
        self._clock = clock
        self._timeout = http_timeout_s
        self.targets: dict[str, Target] = {}
        self.registry = MetricsRegistry()
        self.started_unix_s = clock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-fleet")
        # a minimal Obs bundle so the series recorder and the SLO
        # evaluator plug in UNCHANGED (workload "fleet" arms the
        # fleet-scoped rules; no heartbeat -> alert lines go to the log)
        self.obs = Obs(registry=self.registry,
                       tracer=Tracer(enabled=False))
        self.obs.workload = "fleet"
        # the evaluator's arm-delay clock must agree with the injected
        # clock, or a test's fake time would read as a negative job age
        # and nothing would ever arm
        self.obs.tracer.wall_start = self.started_unix_s
        self.archive: SeriesArchive | None = None
        if cfg.archive_dir:
            self.archive = SeriesArchive(
                cfg.archive_dir,
                segment_records=cfg.archive_segment_records,
                max_segments=cfg.archive_max_segments)
        from map_oxidize_tpu_torch.obs.slo import SloEvaluator, load_rules
        from map_oxidize_tpu_torch.obs.timeseries import TimeSeriesRecorder

        self.series = TimeSeriesRecorder(
            self.registry, interval_s=cfg.poll_interval_s, clock=clock,
            on_sample=(self._archive_sample if self.archive else None))
        self.obs.series = self.series
        incident_dir = (os.path.join(cfg.archive_dir, "incidents")
                        if cfg.archive_dir else None)
        self.alerts = SloEvaluator(
            self.obs, load_rules(cfg.slo_rules, defaults=FLEET_RULES),
            interval_s=cfg.poll_interval_s, incident_dir=incident_dir,
            clock=clock)

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "FleetCollector":
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(5.0,
                                          2 * self.cfg.poll_interval_s))
        if self.archive is not None:
            self.archive.close()

    def _run(self) -> None:
        while True:
            try:
                self.poll_once()
            except Exception as e:  # the collector must never die of
                # one bad sweep — a dead/garbage endpoint is a model
                # state, anything else skips the tick
                _log.warning("fleet poll error (skipping sweep): %s", e)
            if self._stop.wait(self.cfg.poll_interval_s):
                return

    # --- scraping ---------------------------------------------------------

    def _fetch_json(self, url: str) -> dict | None:
        """One endpoint read; None on transport failure, the parsed
        document otherwise (ValueError propagates as refusal — the
        caller distinguishes 'dead' from 'talking garbage')."""
        with urllib.request.urlopen(url, timeout=self._timeout) as resp:
            doc = json.loads(resp.read())
        if not isinstance(doc, dict):
            raise ValueError("payload is not a JSON object")
        return doc

    def poll_once(self, now: float | None = None) -> dict:
        """One sweep: refresh discovery, scrape every active target,
        recompute per-target and aggregate gauges, take a series sample,
        run the SLO tick, and archive.  Returns the fleet status
        document (tests assert on it)."""
        now = self._clock() if now is None else now
        self._refresh_discovery(now)
        with self._lock:
            active = [t for t in self.targets.values() if not t.departed]
        if len(active) > 1:
            # concurrent scrape: target cells are independent until the
            # gauge publish, and a couple of DEAD targets each burning a
            # full connect timeout must not stretch the sweep (and with
            # it the series cadence every window rule divides by) to
            # timeouts x targets
            threads = [threading.Thread(target=self._scrape,
                                        args=(t, now), daemon=True)
                       for t in active]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        elif active:
            self._scrape(active[0], now)
        self._publish_gauges(now)
        self.registry.count("fleet/scrapes", 1)
        self.series.sample_once()
        self.alerts.evaluate_once(now=now)
        doc = self.status_doc(now)
        if self.archive is not None:
            try:
                self.archive.write_latest("status", doc)
                self.archive.write_latest("alerts", self.alerts_doc(now))
                with self._lock:
                    self.archive.write_latest("targets", {
                        "schema": FLEET_STATUS_SCHEMA,
                        "t_unix_s": round(now, 3),
                        "targets": {t.label: t.status
                                    for t in self.targets.values()
                                    if t.status is not None},
                    })
            except Exception as e:  # archive trouble must not stop
                _log.warning("fleet archive write failed: %s", e)
        return doc

    def _refresh_discovery(self, now: float) -> None:
        with self._lock:
            known = set(self.targets)
        found = discover_targets(self.cfg, known=known)
        with self._lock:
            for label, info in found.items():
                t = self.targets.get(label)
                if t is None:
                    self.targets[label] = Target(
                        label=label, url=info["url"],
                        source=info["source"],
                        explicit=info["explicit"],
                        first_seen_unix_s=now, last_ok_unix_s=now)
                    _log.info("[fleet] watching %s (%s)", label,
                              info["source"])
                elif t.departed:
                    # rediscovered: revive with a fresh staleness clock
                    t.departed = False
                    t.last_ok_unix_s = now
                    _log.info("[fleet] target %s returned", label)
            for label, t in self.targets.items():
                if not t.explicit and label not in found \
                        and not t.departed:
                    # its discovery record is GONE — a clean exit, not a
                    # death (a killed process leaves the record behind
                    # and goes stale instead)
                    t.departed = True
                    t.up = False
                    t.stale = False
                    _log.info("[fleet] target %s departed (record "
                              "removed)", label)

    def _scrape(self, t: Target, now: float) -> None:
        t.last_scrape_unix_s = now
        try:
            status = self._fetch_json(t.url + "/status")
        except (urllib.error.URLError, http.client.HTTPException,
                OSError, TimeoutError):
            # HTTPException covers a reclaimed port speaking non-HTTP
            # (BadStatusLine etc.) — it is neither URLError nor OSError,
            # and escaping here would abort the WHOLE sweep every tick
            t.up = False
            t.errors += 1
            t.last_error = "unreachable"
            self.registry.count("fleet/scrape_errors", 1)
        except ValueError as e:
            self._refuse(t, f"malformed payload: {e}")
        else:
            if self._accept(t, status, now):
                # the cheap probe + best-effort extras: /healthz for the
                # job counts, /alerts for correlation, /jobs on resident
                # servers for the live load index — none of their
                # absences (404s, older versions) fails the scrape
                t.healthz = self._fetch_optional(t, "/healthz",
                                                 HEALTHZ_SCHEMA)
                t.alerts = self._fetch_optional(t, "/alerts",
                                                "moxt-alerts-v1")
                if t.kind == "serve":
                    t.jobs = self._fetch_optional(t, "/jobs",
                                                  "moxt-jobs-v1")
        t.stale = (not t.up
                   and now - t.last_ok_unix_s > self.cfg.stale_after_s)

    def _fetch_optional(self, t: Target, path: str,
                        schema: str) -> dict | None:
        try:
            doc = self._fetch_json(t.url + path)
        except (urllib.error.URLError, http.client.HTTPException,
                OSError, ValueError, TimeoutError):
            return None
        return doc if doc.get("schema") == schema else None

    def _accept(self, t: Target, status: dict, now: float) -> bool:
        """Schema/version gate on a transport-successful scrape: only a
        payload this collector understands may enter the merged model."""
        if status.get("schema") != STATUS_SCHEMA:
            self._refuse(t, f"status schema {status.get('schema')!r} "
                            f"(expected {STATUS_SCHEMA!r})")
            return False
        t.up = True
        t.stale = False
        t.last_ok_unix_s = now
        t.last_error = None
        t.status = status
        t.version = (status.get("meta") or {}).get("version")
        return True

    def _refuse(self, t: Target, why: str) -> None:
        """A payload that parsed but cannot merge: counted, logged, the
        model untouched — persistent refusal runs the staleness clock
        out exactly like unreachability."""
        t.up = False
        t.refusals += 1
        t.last_error = f"refused: {why}"
        self.registry.count("fleet/scrape_refused", 1)
        _log.warning("[fleet] refused payload from %s: %s", t.label, why)

    # --- the merged model -------------------------------------------------

    @staticmethod
    def _target_rates(t: Target, now: float) -> float:
        """A target's rows/sec contribution to the fleet load index."""
        if t.kind == "serve" and t.jobs is not None:
            rate = 0.0
            for row in t.jobs.get("jobs") or []:
                if row.get("state") == "running" \
                        and row.get("rows_per_sec"):
                    rate += row["rows_per_sec"]
                elif (row.get("state") == "done"
                      and row.get("finished_unix_s")
                      and now - row["finished_unix_s"] <= RATE_WINDOW_S
                      and row.get("records_in") and row.get("duration_s")):
                    rate += row["records_in"] / max(row["duration_s"],
                                                    1e-9)
            return rate
        prog = (t.status or {}).get("progress") or {}
        return float(prog.get("rows_per_sec") or 0.0)

    @staticmethod
    def _target_hbm(t: Target) -> tuple[float, float]:
        """(max live HBM bytes, published budget bytes or 0)."""
        hbm = (t.status or {}).get("hbm") or {}
        live = max((v for k, v in hbm.items()
                    if k.startswith("hbm/live_bytes")
                    and isinstance(v, (int, float))), default=0.0)
        budget = hbm.get("hbm/budget_bytes") or 0.0
        return float(live), float(budget)

    def _target_metrics(self, t: Target, now: float) -> dict:
        """The per-target gauge set (the labeled /metrics block, the
        flat registry spellings, and the /status row share it)."""
        jobs_h = (t.healthz or {}).get("jobs") or {}
        live, budget = self._target_hbm(t)
        m = {
            "up": 0.0 if not t.up else 1.0,
            "stale": 1.0 if t.stale else 0.0,
            "staleness_s": (0.0 if t.up or t.departed else
                            round(max(now - t.last_ok_unix_s, 0.0), 3)),
            "rows_per_sec": round(self._target_rates(t, now), 1),
            "hbm_bytes": live,
            "queue_depth": float(jobs_h.get("queue_depth") or 0),
            "jobs_running": float(jobs_h.get("running") or 0),
            "alerts_firing": float(len((t.alerts or {}).get("firing")
                                       or [])),
        }
        if budget > 0:
            # always refreshed while the target publishes a budget, and
            # zeroed when the target goes down — a frac gauge frozen at
            # its last high reading would keep the critical
            # fleet-hbm-watermark alert firing forever (the staleness
            # rule owns dead targets)
            m["hbm_frac"] = round(live / budget, 4) if t.up else 0.0
        data = (t.status or {}).get("data") or {}
        imb = data.get("imbalance_factor")
        if isinstance(imb, (int, float)):
            # key-skew rollup: only while the target publishes a
            # data-plane section (same presence contract as hbm_frac)
            m["imbalance_factor"] = round(float(imb), 4)
        # calibration rollup: store warmth + chooser coverage, only
        # while the target publishes a calib section (same presence
        # contract as hbm_frac — uncalibrated targets have no gauges,
        # so the fleet-calib-cold rule can't false-fire on them)
        cal = (t.status or {}).get("calib") or {}
        runs = cal.get("store_runs")
        if isinstance(runs, (int, float)):
            m["calib_store_runs"] = float(runs)
        cov = cal.get("coverage_pct")
        if isinstance(cov, (int, float)):
            m["calib_coverage_pct"] = round(float(cov), 1)
        return m

    def _publish_gauges(self, now: float) -> None:
        with self._lock:
            rows = {t.label: (t, self._target_metrics(t, now))
                    for t in self.targets.values()}
        agg_rate = agg_queue = agg_jobs = agg_alerts = 0.0
        hbm_max = imb_max = 0.0
        n_up = n_stale = n_active = 0
        for label, (t, m) in rows.items():
            for name in _TARGET_GAUGES + ("hbm_frac", "imbalance_factor",
                                          "calib_store_runs",
                                          "calib_coverage_pct"):
                if name in m:
                    self.registry.set(f"fleet/target/{label}/{name}",
                                      m[name])
            if t.departed:
                continue
            n_active += 1
            n_up += int(t.up)
            n_stale += int(t.stale)
            if not t.up:
                # a dead target's LAST-KNOWN figures stay on its own
                # gauges (post-mortem evidence) but must not keep
                # inflating the load index the router reads
                continue
            agg_rate += m["rows_per_sec"]
            agg_queue += m["queue_depth"]
            agg_jobs += m["jobs_running"]
            agg_alerts += m["alerts_firing"]
            hbm_max = max(hbm_max, m["hbm_bytes"])
            imb_max = max(imb_max, m.get("imbalance_factor", 0.0))
        self.registry.set("fleet/targets", n_active)
        self.registry.set("fleet/targets_up", n_up)
        self.registry.set("fleet/targets_stale", n_stale)
        self.registry.set("fleet/rows_per_sec", round(agg_rate, 1))
        self.registry.set("fleet/hbm_max_bytes", hbm_max)
        self.registry.set("fleet/queue_depth", agg_queue)
        self.registry.set("fleet/jobs_running", agg_jobs)
        self.registry.set("fleet/target_alerts_firing", agg_alerts)
        # the worst partition skew anywhere on the fleet — the number a
        # fleet-scope skew SLO rule (or a capacity planner) watches
        self.registry.set("fleet/imbalance_max", round(imb_max, 4))

    def _archive_sample(self, ts: float, snap: dict) -> None:
        # only the fleet's own series persist — per-target raw /status
        # documents ride the targets-latest snapshot instead
        self.archive.append(ts, snap)

    # --- documents --------------------------------------------------------

    def status_doc(self, now: float | None = None) -> dict:
        """``GET /status`` (``moxt-fleet-status-v1``): per-target rows
        plus the fleet aggregates — the load index the router consumes."""
        from map_oxidize_tpu_torch import __version__

        now = self._clock() if now is None else now
        with self._lock:
            targets = list(self.targets.values())
        rows = []
        for t in sorted(targets, key=lambda x: x.label):
            m = self._target_metrics(t, now)
            state = ("departed" if t.departed else
                     "stale" if t.stale else
                     "up" if t.up else "down")
            row = {
                "target": t.label, "url": t.url, "source": t.source,
                "kind": t.kind, "state": state,
                "up": t.up, "stale": t.stale, "departed": t.departed,
                "staleness_s": m["staleness_s"],
                "last_ok_unix_s": round(t.last_ok_unix_s, 3),
                "version": t.version,
                "workload": ((t.status or {}).get("meta") or {})
                .get("workload"),
                "phase": (t.status or {}).get("phase"),
                "rows_per_sec": m["rows_per_sec"],
                "hbm_bytes": m["hbm_bytes"],
                "queue_depth": m["queue_depth"],
                "jobs_running": m["jobs_running"],
                "alerts_firing": m["alerts_firing"],
                "scrape_errors": t.errors,
                "scrape_refused": t.refusals,
            }
            if "hbm_frac" in m:
                row["hbm_frac"] = m["hbm_frac"]
            if "imbalance_factor" in m:
                row["imbalance_factor"] = m["imbalance_factor"]
            if "calib_store_runs" in m:
                row["calib_store_runs"] = m["calib_store_runs"]
            if "calib_coverage_pct" in m:
                row["calib_coverage_pct"] = m["calib_coverage_pct"]
            if t.last_error:
                row["last_error"] = t.last_error
            rows.append(row)
        with self.registry._lock:
            agg = {k[len("fleet/"):]: v
                   for k, v in self.registry.gauges.items()
                   if k.startswith("fleet/")
                   and not k.startswith("fleet/target/")}
            counters = {k: v for k, v in self.registry.counters.items()
                        if k.startswith("fleet/")}
        doc = {
            "schema": FLEET_STATUS_SCHEMA,
            "version": __version__,
            "t_unix_s": round(now, 3),
            "uptime_s": round(max(now - self.started_unix_s, 0.0), 3),
            "interval_s": self.cfg.poll_interval_s,
            "stale_after_s": self.cfg.stale_after_s,
            "counts": {
                "targets": sum(1 for t in targets if not t.departed),
                "up": sum(1 for t in targets if t.up),
                "stale": sum(1 for t in targets if t.stale),
                "departed": sum(1 for t in targets if t.departed),
            },
            "aggregates": agg,
            "counters": counters,
            "targets": rows,
        }
        if self.archive is not None:
            doc["archive"] = self.archive.doc()
        return doc

    def alerts_doc(self, now: float | None = None) -> dict:
        """``GET /alerts`` (``moxt-fleet-alerts-v1``): the collector's
        own evaluator export (fleet-scope rules over the merged series)
        plus the cross-target correlation — one incident per rule,
        naming every target it fires on."""
        now = self._clock() if now is None else now
        with self._lock:
            per_target = {t.label: t.alerts for t in
                          self.targets.values()
                          if not t.departed and t.alerts is not None}
        fleet_export = self.alerts.export()
        return {
            "schema": FLEET_ALERTS_SCHEMA,
            "t_unix_s": round(now, 3),
            "fleet": fleet_export,
            "incidents": correlate_alerts(per_target, fleet_export,
                                          now=now),
            "per_target": {
                label: {"firing": len(doc.get("firing") or []),
                        "counts": doc.get("counts")}
                for label, doc in per_target.items()},
        }

    def healthz_doc(self) -> dict:
        from map_oxidize_tpu_torch import __version__

        now = self._clock()
        with self._lock:
            n = sum(1 for t in self.targets.values() if not t.departed)
        return {
            "schema": HEALTHZ_SCHEMA,
            "version": __version__,
            "t_unix_s": round(now, 3),
            "uptime_s": round(max(now - self.started_unix_s, 0.0), 3),
            "workload": "fleet",
            "phase": "collect",
            "targets": n,
        }

    def metrics_text(self) -> str:
        """``GET /metrics``: the per-target gauges as LABELED Prometheus
        series (``moxt_fleet_target_up{target="host:port"}`` ...) — the
        shape a router's PromQL reads — followed by the collector
        registry's flat export (fleet aggregates, scrape counters,
        ``alerts/firing``, and the flat per-target spellings the series
        ring records)."""
        now = self._clock()
        with self._lock:
            rows = {t.label: self._target_metrics(t, now)
                    for t in self.targets.values() if not t.departed}
        lines: list[str] = []
        for name in _TARGET_GAUGES + ("hbm_frac", "calib_store_runs",
                                      "calib_coverage_pct"):
            fam = sanitize_metric_name(f"fleet_target_{name}")
            typed = False
            for label in sorted(rows):
                m = rows[label]
                if name not in m:
                    continue
                if not typed:
                    lines.append(f"# TYPE {fam} gauge")
                    typed = True
                lines.append(f'{fam}{{target="{label}"}} '
                             f"{float(m[name]):.12g}")
        return "\n".join(lines) + ("\n" if lines else "") \
            + prometheus_text(self.registry)


def correlate_alerts(per_target: dict[str, dict], fleet_export: dict,
                     window_s: float = CORRELATE_WINDOW_S,
                     now: float | None = None) -> list[dict]:
    """Cross-target incident correlation: the same rule firing on k
    targets within the window collapses into ONE fleet incident naming
    all k.  Two sources join:

    * each target's own ``/alerts`` — currently-firing alerts plus
      'fired' timeline events within the window (a flap that already
      resolved still belongs to the incident's evidence);
    * the fleet evaluator's own firing states, whose
      ``fleet/target/<label>/...`` series names map back to targets.

    Sorted widest incident first (k desc, then severity)."""
    now = time.time() if now is None else now
    incidents: dict[str, dict] = {}

    def _join(rule: str, target: str, severity, since, firing: bool,
              scope: str) -> None:
        inc = incidents.get(rule)
        if inc is None:
            inc = incidents[rule] = {
                "rule": rule, "scope": scope, "targets": {},
                "severity": severity or "warning",
                "first_t_unix_s": since}
        cell = inc["targets"].get(target)
        if cell is None or (firing and not cell["firing"]):
            inc["targets"][target] = {"firing": firing,
                                      "since_unix_s": since}
        if severity == "critical":
            inc["severity"] = "critical"
        if since is not None and (inc["first_t_unix_s"] is None
                                  or since < inc["first_t_unix_s"]):
            inc["first_t_unix_s"] = since

    for label, doc in per_target.items():
        for a in doc.get("firing") or []:
            _join(a.get("rule", "?"), label, a.get("severity"),
                  a.get("since_unix_s"), True, "targets")
        for ev in doc.get("timeline") or []:
            if ev.get("event") == "fired" \
                    and now - (ev.get("t_unix_s") or 0) <= window_s:
                _join(ev.get("rule", "?"), label, ev.get("severity"),
                      ev.get("t_unix_s"), False, "targets")
    for a in fleet_export.get("firing") or []:
        series = a.get("series") or ""
        target = series
        if series.startswith("fleet/target/"):
            # fleet/target/<label>/<gauge> -> the label names the target
            target = series[len("fleet/target/"):].rsplit("/", 1)[0]
        _join(a.get("rule", "?"), target, a.get("severity"),
              a.get("since_unix_s"), True, "fleet")
    for ev in fleet_export.get("timeline") or []:
        if ev.get("event") != "fired" \
                or now - (ev.get("t_unix_s") or 0) > window_s:
            continue
        series = ev.get("series") or ""
        target = series
        if series.startswith("fleet/target/"):
            target = series[len("fleet/target/"):].rsplit("/", 1)[0]
        _join(ev.get("rule", "?"), target, ev.get("severity"),
              ev.get("t_unix_s"), False, "fleet")
    out = []
    for inc in incidents.values():
        targets = inc.pop("targets")
        inc["targets"] = sorted(targets)
        inc["k"] = len(targets)
        inc["firing"] = sorted(t for t, c in targets.items()
                               if c["firing"])
        inc["active"] = bool(inc["firing"])
        out.append(inc)
    out.sort(key=lambda i: (-i["k"],
                            0 if i["severity"] == "critical" else 1,
                            i["rule"]))
    return out


# --- the fleet HTTP plane ---------------------------------------------------


class _FleetHandler(BaseHTTPRequestHandler):
    server_version = "moxt-fleet"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        col = self.server.collector
        path = self.path.split("?", 1)[0]
        try:
            if path == "/":
                self._json({"schema": FLEET_STATUS_SCHEMA,
                            "endpoints": ["/healthz", "/metrics",
                                          "/status", "/alerts",
                                          "/series"]})
            elif path == "/healthz":
                self._json(col.healthz_doc())
            elif path == "/metrics":
                self._ok(col.metrics_text().encode(),
                         "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/status":
                self._json(col.status_doc())
            elif path == "/alerts":
                self._json(col.alerts_doc())
            elif path == "/series":
                self._json(col.series.export())
            else:
                self._json({"error": f"unknown path {path!r}"}, code=404)
        except Exception as e:  # a scrape bug must not kill the fleet
            try:
                self._json({"error": f"{type(e).__name__}: {e}"},
                           code=500)
            except Exception:
                pass

    def _ok(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, doc: dict, code: int = 200) -> None:
        from map_oxidize_tpu_torch.obs import _json_default

        self._ok(json.dumps(doc, default=_json_default).encode(),
                 "application/json", code)

    def log_message(self, fmt, *args):  # route access logs to debug
        _log.debug("fleet-serve: " + fmt, *args)


class _FleetHTTP(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    collector = None                     # set after construction


class FleetServer:
    """The collector's own HTTP plane (same daemon-thread shape as
    :class:`~map_oxidize_tpu_torch.obs.serve.ObsServer`); honors the
    ``MOXT_OBS_PORT_FILE`` discovery hook with a ``fleet <port>`` line."""

    def __init__(self, collector: FleetCollector, port: int,
                 host: str = "127.0.0.1"):
        self._httpd = _FleetHTTP((host, port), _FleetHandler)
        self._httpd.collector = collector
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-serve")
        self._stopped = False

    def start(self) -> "FleetServer":
        self._thread.start()
        _log.info("[fleet] serving the fleet plane on %s "
                  "(/metrics /status /alerts /series)", self.url)
        portfile = os.environ.get("MOXT_OBS_PORT_FILE")
        if portfile:
            try:
                fd = os.open(portfile,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                try:
                    os.write(fd, f"fleet {self.port}\n".encode())
                finally:
                    os.close(fd)
            except OSError as e:  # discovery is best-effort
                _log.warning("cannot write MOXT_OBS_PORT_FILE %s: %s",
                             portfile, e)
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception as e:  # pragma: no cover - defensive
            _log.debug("fleet server shutdown: %s", e)
