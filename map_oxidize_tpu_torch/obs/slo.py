"""SLO and alerting plane: declarative rules watched continuously in
process.  A copy of the JAX package's ``obs/slo.py`` (``SloRule`` :88,
``DEFAULT_RULES`` :172, ``load_rules`` :288, ``SloEvaluator`` :348).

* :class:`SloRule` — one declarative rule over the time-series ring
  (:mod:`map_oxidize_tpu_torch.obs.timeseries`): a glob over series names,
  a ``kind`` (``value`` — latest reading, optionally as a fraction of a
  ``denominator`` series; ``delta`` — change over ``window_s``; ``rate``
  — that change per second), a comparison op and threshold, a ``for_s``
  debounce (the condition must HOLD that long before the alert fires), an
  ``after_s`` arm delay (compiles at job start are normal, compiles at
  minute five are not), and a ``scope`` (``job`` / ``serve`` / ``any``)
  so serve-plane rules do not evaluate against one-shot jobs and vice
  versa.
* :class:`SloEvaluator` — a daemon thread (the series sampler's cadence)
  running every armed rule against the ring each tick, with a firing ->
  resolved state machine per (rule, matched series).  Ring wraparound is
  handled by construction: a ``delta``/``rate`` window that reaches past
  the oldest surviving sample clamps to it (the rate divides by the
  ACTUAL time spanned, so a wrapped ring never fabricates a burst).
* **incident bundles** — each firing writes a non-fatal bundle
  (``incident.json``: the rule, the observed value, the matched series'
  recent window and a ``/status`` snapshot) under ``incident_dir``
  (default: the run's ``crash_dir``), bounded per run.

Rules come from the built-in :data:`DEFAULT_RULES` plus ``slo_rules`` (a
JSON file path or inline JSON: a list EXTENDS the defaults, an object
``{"defaults": false, "rules": [...]}`` replaces them).  The evaluator
runs whenever the time-series recorder runs (the live plane implies it);
every transition is announced as an ``[alert]`` heartbeat line, counted
into ``alerts/fired`` / ``alerts/resolved``, exported live at ``/alerts``
(``moxt-alerts-v1``), and carried by the metrics document, ledger entries
and crash bundles as a bounded event timeline.

The rules that read the comms or multi-process gauges (``comms-burst``,
``critpath-process-blame``) stay armed and silent until the sharded and
multi-process paths publish those gauges.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

ALERTS_SCHEMA = "moxt-alerts-v1"
INCIDENT_SCHEMA = "moxt-incident-v1"

#: per-run ceiling on incident bundles: an alert storm (a rule matching
#: a hundred series, all firing) must not fill the disk — past it the
#: timeline/counters still record every transition, bundles stop
MAX_INCIDENTS = 16

#: bounded event history carried by exports (metrics doc, ledger entry,
#: crash bundle) and served at /alerts
TIMELINE_CAP = 128

_KINDS = ("value", "delta", "rate")
_OPS = (">", ">=", "<", "<=")
#: "info" is visibility without urgency (e.g. the fleet's cold-
#: calibration-store rule): it fires, correlates, and lands in exports
#: like any alert, but readers may render it below warnings
_SEVERITIES = ("info", "warning", "critical")
#: "fleet" arms only on a fleet collector's evaluator
#: (:mod:`map_oxidize_tpu_torch.obs.fleet`), whose merged cross-target series
#: no single job or server ever records
_SCOPES = ("any", "job", "serve", "fleet")

_RULE_FIELDS = frozenset({
    "name", "metric", "kind", "op", "threshold", "window_s", "for_s",
    "after_s", "scope", "severity", "denominator", "description",
    "evidence",
})


@dataclass
class SloRule:
    """One declarative SLO rule (see the module docstring for the
    evaluation model).  ``metric`` is an fnmatch glob over the series
    names the ring records — counters and gauges by name, histograms as
    ``<name>/p50``/``p95``/``count``."""

    name: str
    metric: str
    kind: str = "value"
    op: str = ">"
    threshold: float = 0.0
    #: delta/rate lookback; clamped to the ring's surviving span
    window_s: float = 60.0
    #: debounce: the condition must hold this long before firing
    for_s: float = 0.0
    #: arm delay from job start (cold-start warmup exclusion)
    after_s: float = 0.0
    scope: str = "any"
    severity: str = "warning"
    #: value rules only: evaluate metric / denominator (skipped while
    #: the denominator series is absent or zero) — HBM watermark as a
    #: fraction of the admission budget, and friends
    denominator: str | None = None
    #: cross-link: metric name(s) whose figures corroborate a firing —
    #: rendered in incident bundles and /alerts so the responder reads
    #: the corroborating gauge next to the trigger (e.g. the data-plane
    #: skew rule cross-links the critpath straggler-save fraction:
    #: a skewed partition should show up as a blamed process)
    evidence: str = ""
    description: str = ""

    def validate(self) -> "SloRule":
        if not isinstance(self.name, str) or not isinstance(
                self.metric, str) or not self.name or not self.metric:
            raise ValueError("SLO rule needs a name and a metric glob")
        for fld in ("threshold", "window_s", "for_s", "after_s"):
            v = getattr(self, fld)
            # the config-time validation promise: a string threshold
            # must fail HERE, not TypeError out of every evaluator tick
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"rule {self.name!r}: {fld} must be a "
                                 f"number, got {v!r}")
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: kind must be one of "
                             f"{_KINDS}, got {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: op must be one of "
                             f"{_OPS}, got {self.op!r}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"rule {self.name!r}: severity must be one "
                             f"of {_SEVERITIES}, got {self.severity!r}")
        if self.scope not in _SCOPES:
            raise ValueError(f"rule {self.name!r}: scope must be one of "
                             f"{_SCOPES}, got {self.scope!r}")
        if self.window_s <= 0:
            raise ValueError(f"rule {self.name!r}: window_s must be "
                             "positive")
        if self.for_s < 0 or self.after_s < 0:
            raise ValueError(f"rule {self.name!r}: for_s and after_s "
                             "must be >= 0")
        if self.denominator is not None and self.kind != "value":
            raise ValueError(f"rule {self.name!r}: denominator only "
                             "applies to value rules")
        if not isinstance(self.evidence, str):
            raise ValueError(f"rule {self.name!r}: evidence must be a "
                             f"metric-name string, got {self.evidence!r}")
        return self

    def holds(self, observed: float) -> bool:
        t = self.threshold
        if self.op == ">":
            return observed > t
        if self.op == ">=":
            return observed >= t
        if self.op == "<":
            return observed < t
        return observed <= t


#: built-in rules.  Calibrated to stay SILENT on a healthy run (the
#: smoke runs gate exactly that): warmup exclusions where a cold
#: start legitimately trips the signal, ceilings far above measured
#: healthy values, and serve-scoped rules that only see the resident
#: server's registry.  Override or extend via --slo-rules.
DEFAULT_RULES: tuple[dict, ...] = (
    # stall episodes are evidence of a wedged feed loop or a straggler-
    # gated collective — any increase alerts (mirrors the ledger gate)
    {"name": "stall-episodes", "metric": "heartbeat/stalls",
     "kind": "delta", "op": ">", "threshold": 0, "window_s": 120,
     "severity": "critical",
     "description": "heartbeat stall episodes increased"},
    # the flat-program-count invariant, live: compiles during the
    # first five minutes are warmup; compiles after that are an
    # input-shape-set leak recompiling mid-stream
    {"name": "recompile-after-warmup", "metric": "compile/*/compiles",
     "kind": "delta", "op": ">", "threshold": 0, "window_s": 120,
     "after_s": 300, "scope": "job", "severity": "critical",
     "description": "recompile on a warmed-up job "
                    "(flat-program-count invariant)"},
    # the serve-plane form: the scheduler counts compile deltas from
    # job 2 on into serve/warm_compiles — a warm server must never
    # move it (the zero-compile-delta story, continuously enforced)
    {"name": "warm-serve-recompile", "metric": "serve/warm_compiles",
     "kind": "delta", "op": ">", "threshold": 0, "window_s": 300,
     "scope": "serve", "severity": "critical",
     "description": "a warm resident server recompiled on a "
                    "repeat-shape job"},
    # dispatch-gap p95 ceiling: the measured healthy floor is
    # ~150-250 ms/launch; sustained seconds-long gaps mean the host is
    # starving the device (GIL storm, swap, a wedged producer)
    {"name": "dispatch-gap-p95", "metric": "device/dispatch_gap_ms/p95",
     "kind": "value", "op": ">", "threshold": 5000, "for_s": 10,
     "scope": "job", "severity": "warning",
     "description": "per-dispatch gap p95 above 5s — host starving "
                    "the device"},
    # serve queue-wait p95 ceiling: waiting a minute for a slot is an
    # under-provisioned server (or a deferred-job pileup)
    {"name": "serve-queue-wait-p95", "metric": "serve/queue_wait_ms/p95",
     "kind": "value", "op": ">", "threshold": 60_000, "for_s": 10,
     "scope": "serve", "severity": "warning",
     "description": "p95 queue wait above 60s — server "
                    "under-provisioned for its load"},
    # HBM watermark as a fraction of the admission budget (the
    # denominator gauge exists only where a budget was probed/configured,
    # so CPU smokes skip this rule by construction)
    {"name": "hbm-watermark", "metric": "hbm/live_bytes_*",
     "kind": "value", "op": ">", "threshold": 0.95,
     "denominator": "hbm/budget_bytes", "for_s": 5,
     "severity": "critical",
     "description": "live HBM above 95% of the admission budget"},
    # MFU floor: shipped armed-but-at-zero because a universal floor
    # does not exist (CPU smoke MFU is legitimately ~0%); override the
    # threshold via --slo-rules with the fleet's measured baseline
    {"name": "mfu-floor", "metric": "xprof/*/mfu_pct",
     "kind": "value", "op": "<", "threshold": 0.0, "scope": "job",
     "description": "program MFU below the configured floor (default "
                    "floor 0 never fires — set your fleet's baseline "
                    "via --slo-rules)"},
    # comms burst: a sustained >20 GB/s accounted collective payload
    # rate for the same job is redistribution gone circular
    {"name": "comms-burst", "metric": "comms/*/bytes", "kind": "rate",
     "op": ">", "threshold": 20e9, "window_s": 30, "for_s": 10,
     "severity": "warning",
     "description": "sustained collective payload rate above 20 GB/s"},
    # causal straggler alarm: fixing ONE process (the what-if "at
    # peer-median speed" replay) would cut the wall by more than 30% —
    # the process's blame share of the wall, measured causally.  Raw
    # path ownership is deliberately NOT the trigger: near-tied
    # arrivals put ~100% ownership on a coin-flip binder even on
    # healthy runs, while the replay saving is ~0 on a tie and large
    # only when a straggler is genuinely ON the critical path.  The
    # gauge is published ONLY for multi-process runs (post-merge, which
    # takes one final series sample + evaluator tick), so a single-chip
    # job can never trip this; a firing lands in the ledger's
    # alerts/fired gate counter + an incident bundle.
    {"name": "critpath-process-blame",
     "metric": "critpath/straggler_save_frac", "kind": "value",
     "op": ">", "threshold": 0.30, "scope": "job",
     "severity": "warning",
     "description": "one process's blame share of the wall exceeds 30% "
                    "(straggler on the critical path — see obs "
                    "critpath for blame/slack/what-if)"},
    # data-plane skew alarm: max/mean partition rows above 6x means the
    # key distribution concentrates the shuffle onto a few partitions —
    # the precondition for the straggler pattern the critpath plane
    # blames, so the incident cross-links its save fraction as
    # corroborating evidence (skewed partition <-> blamed process).
    # 6.0 stays silent on healthy hash-partitioned corpora (measured
    # smoke imbalance ~1-3x even on tiny vocabularies); an adversarial
    # Zipf corpus trips it.  The gauge is published at audit finish
    # (post-merge on distributed runs, like the critpath gauges).
    {"name": "data-partition-skew", "metric": "data/imbalance_factor",
     "kind": "value", "op": ">", "threshold": 6.0, "scope": "job",
     "severity": "warning",
     "evidence": "critpath/straggler_save_frac",
     "description": "partition rows max/mean above 6x — key skew "
                    "concentrating the shuffle on few partitions (see "
                    "obs data for the heatmap; corroborate with the "
                    "critpath straggler save fraction)"},
    # plan observatory drift: a resident server re-plans every
    # submission from its own calibration history, and the scheduler
    # publishes the MEDIAN prediction error of its recently finished
    # jobs onto the server registry (median-of-recent so one noisy
    # micro-job cannot trip it; a cold server publishes nothing and
    # stays silent by construction, like a cold CLI run's
    # platform_default provenance).  Sustained error above 150% means
    # the stored curves no longer describe the machine (stale store
    # after a topology/attach change, doctored evidence) — recalibrate
    # or clear the store.  The one-shot form of the same signal is the
    # plan/model_error_pct ledger gate (obs diff --gate).
    {"name": "plan-model-drift", "metric": "plan/model_error_pct",
     "kind": "value", "op": ">", "threshold": 150, "for_s": 5,
     "scope": "serve", "severity": "warning",
     "evidence": "plan/predicted_wall_ms",
     "description": "resident server's plan predictions went stale — "
                    "median predicted-vs-actual wall error above 150% "
                    "(see obs plan; recalibrate or clear the store)"},
)


def load_rules(spec: str | None,
               defaults: tuple[dict, ...] = DEFAULT_RULES
               ) -> list[SloRule]:
    """Resolve ``--slo-rules`` into the rule set.  ``spec`` may be None/
    empty (defaults only), a path to a JSON file, or inline JSON.  A
    JSON list EXTENDS the defaults; ``{"defaults": false,
    "rules": [...]}`` replaces them.  A later rule with an existing name
    overrides the earlier one (so defaults are tunable by name).
    ``defaults`` is the built-in set ``{"defaults": true}`` refers to —
    :data:`DEFAULT_RULES` for jobs/servers, the fleet collector passes
    its own :data:`~map_oxidize_tpu_torch.obs.fleet.FLEET_RULES`."""
    parsed = None
    if spec:
        text = spec.strip()
        if text.startswith(("[", "{")):
            parsed = json.loads(text)
        else:
            with open(spec) as f:
                parsed = json.load(f)
    use_defaults = True
    extra: list = []
    if isinstance(parsed, list):
        extra = parsed
    elif isinstance(parsed, dict):
        use_defaults = bool(parsed.get("defaults", True))
        extra = parsed.get("rules", [])
        if not isinstance(extra, list):
            raise ValueError('"rules" must be a list of rule objects')
    elif parsed is not None:
        raise ValueError("--slo-rules JSON must be a list of rules or "
                         'an object with a "rules" list')
    raw = (list(defaults) if use_defaults else []) + extra
    by_name: dict[str, SloRule] = {}
    for d in raw:
        if not isinstance(d, dict):
            raise ValueError(f"each rule must be a JSON object, got {d!r}")
        unknown = set(d) - _RULE_FIELDS
        if unknown:
            raise ValueError(
                f"unknown SLO rule field(s) {sorted(unknown)} in "
                f"{d.get('name', d)!r}")
        try:
            rule = SloRule(**d)
        except TypeError as e:  # a missing required field must surface
            # as the config-time ValueError every caller catches
            raise ValueError(f"bad SLO rule {d!r}: {e}") from e
        rule.validate()
        by_name[rule.name] = rule      # later wins: defaults are tunable
    return list(by_name.values())


@dataclass
class _AlertState:
    """Per-(rule, series) state machine cell."""

    state: str = "ok"              # ok | pending | firing
    since_unix_s: float = 0.0      # pending/firing start
    value: float | None = None     # last observed


class SloEvaluator:
    """Evaluates the rule set against one job's time-series ring on a
    daemon thread (``interval_s`` — the series sampler's cadence by
    default).  ``clock`` is injectable and :meth:`evaluate_once` is the
    whole tick, so tests drive it deterministically without the thread.
    """

    def __init__(self, obs, rules: list[SloRule], config=None,
                 interval_s: float = 1.0, incident_dir: str | None = None,
                 clock=time.time):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.obs = obs
        self.rules = list(rules)
        self.config = config
        self.interval_s = interval_s
        self.incident_dir = incident_dir
        self._clock = clock
        #: (rule.name, series name) -> state cell
        self._states: dict[tuple[str, str], _AlertState] = {}
        #: bounded fired/resolved event history, oldest first
        self.timeline: list[dict] = []
        self.fired_total = 0
        self.resolved_total = 0
        self.incidents_written = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-slo")

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop the thread and run one final evaluation (against the
        series recorder's final sample), so a condition that cleared at
        the very end still resolves in the exported timeline."""
        if not self._stop.is_set():
            self._stop.set()
            self.evaluate_once()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # the watcher must never kill the job
                _log.warning("SLO evaluation error (skipping tick): %s", e)

    # --- evaluation -------------------------------------------------------

    @property
    def _scope(self) -> str:
        """This evaluator's plane: the resident server's own bundle
        (workload 'serve') evaluates serve-scoped rules, a fleet
        collector's (workload 'fleet') the fleet-scoped ones; everything
        else is a job."""
        wl = getattr(self.obs, "workload", None)
        return wl if wl in ("serve", "fleet") else "job"

    def evaluate_once(self, now: float | None = None) -> list[dict]:
        """One tick: run every armed rule against the ring, advance the
        state machines, announce/record transitions.  Returns the
        transition events of this tick (tests assert on them)."""
        series_rec = getattr(self.obs, "series", None)
        if series_rec is None:
            return []
        now = self._clock() if now is None else now
        job_age = now - self.obs.tracer.wall_start
        scope = self._scope
        armed = [r for r in self.rules
                 if (r.scope == "any" or r.scope == scope)
                 and job_age >= r.after_s]
        if not armed:
            return []
        # glob against the cheap name list first, then pull a TARGETED
        # export — the per-tick read must not materialize the whole ring
        all_names = series_rec.latest_names()
        if not all_names:
            return []
        matched = {r.name: fnmatch.filter(all_names, r.metric)
                   for r in armed}
        needed: set[str] = set()
        for r in armed:
            needed.update(matched[r.name])
            if r.denominator is not None:
                needed.add(r.denominator)
        if not needed:
            return []
        export = series_rec.export(only=needed)
        t = export["t_unix_s"]
        if not t:
            return []
        series = export["series"]
        events: list[dict] = []
        for rule in armed:
            for name in matched[rule.name]:
                if name not in series:
                    continue
                observed = self._observe(rule, name, t, series, now)
                if observed is None:
                    continue
                ev = self._advance(rule, name, observed, now)
                if ev is not None:
                    events.append(ev)
        with self._lock:
            firing = sum(1 for s in self._states.values()
                         if s.state == "firing")
        self.obs.registry.set("alerts/firing", firing)
        return events

    def _observe(self, rule: SloRule, name: str, t: list,
                 series: dict, now: float) -> float | None:
        """The rule's observed value for one matched series, or None
        when the series has no usable reading yet (rule skipped, state
        untouched)."""
        vals = series[name]
        latest = _latest(vals)
        if latest is None:
            return None
        v_now, i_now = latest
        if rule.kind == "value":
            if rule.denominator is None:
                return v_now
            dvals = series.get(rule.denominator)
            if dvals is None:
                return None
            dlatest = _latest(dvals)
            if dlatest is None or not dlatest[0]:
                return None
            return v_now / dlatest[0]
        # delta/rate: reference = the newest sample at or before the
        # window start; a window reaching past the ring's oldest
        # surviving sample clamps to that oldest sample (wrap-safe:
        # rate divides by the ACTUAL span, never the nominal window)
        target = now - rule.window_s
        ref = _at_or_before(t, vals, target)
        if ref is None:
            return None
        v_ref, i_ref = ref
        ref_t = t[i_ref]
        if ref_t > target and i_ref > 0:
            # the series APPEARED mid-ring: the tick before its first
            # sample proves it did not exist, so the baseline is 0 at
            # that tick — counters are created lazily on their first
            # increment (heartbeat/stalls, serve/warm_compiles), and
            # that FIRST increment must fire, not only the second.  A
            # wrapped ring whose oldest surviving sample already holds
            # the series (i_ref == 0) keeps the clamp baseline instead
            v_ref, ref_t = 0.0, t[i_ref - 1]
        elif i_ref >= i_now:
            return None                 # no span to difference over
        delta = v_now - v_ref
        if rule.kind == "delta":
            return delta
        dt = t[i_now] - ref_t
        if dt <= 0:
            return None
        return delta / dt

    def _advance(self, rule: SloRule, name: str, observed: float,
                 now: float) -> dict | None:
        """One state-machine step; returns a fired/resolved event on a
        transition."""
        key = (rule.name, name)
        with self._lock:
            cell = self._states.get(key)
            if cell is None:
                cell = self._states[key] = _AlertState()
            cell.value = observed
            holds = rule.holds(observed)
            if cell.state == "firing":
                if holds:
                    return None
                cell.state = "ok"
                return self._record_locked("resolved", rule, name,
                                           observed, now)
            if not holds:
                cell.state = "ok"
                return None
            if cell.state == "ok":
                cell.state = "pending"
                cell.since_unix_s = now
            if now - cell.since_unix_s < rule.for_s:
                return None             # still debouncing
            cell.state = "firing"
            cell.since_unix_s = now
            event = self._record_locked("fired", rule, name, observed, now)
        # incident bundle OUTSIDE the state lock (filesystem I/O)
        self._write_incident(rule, name, observed, now)
        return event

    def _record_locked(self, what: str, rule: SloRule, name: str,
                       observed: float, now: float) -> dict:
        event = {
            "event": what,
            "rule": rule.name,
            "series": name,
            "value": round(float(observed), 6),
            "threshold": rule.threshold,
            "op": rule.op,
            "severity": rule.severity,
            "t_unix_s": round(now, 3),
        }
        self.timeline.append(event)
        del self.timeline[:-TIMELINE_CAP]
        if what == "fired":
            self.fired_total += 1
        else:
            self.resolved_total += 1
        # counters ride the registry: summary -> ledger entry -> gate
        self.obs.registry.count(f"alerts/{what}", 1)
        self._announce(
            f"[alert] {'FIRING' if what == 'fired' else 'resolved'} "
            f"{rule.name}: {name}={observed:g} "
            f"({rule.op} {rule.threshold:g}, {rule.severity})")
        return event

    def _announce(self, line: str) -> None:
        """Transition lines ride the heartbeat when one is printing;
        silent heartbeats (the live plane's tracking-only mode) fall
        back to the logger so the operator still sees the alert."""
        hb = getattr(self.obs, "heartbeat", None)
        if hb is not None and not getattr(hb, "silent", False):
            hb.announce(line)
        else:
            _log.warning("%s", line)

    # --- incident bundles -------------------------------------------------

    def _write_incident(self, rule: SloRule, name: str, observed: float,
                        now: float) -> str | None:
        """Flight-recorder-style evidence for one firing: the rule, the
        matched series' surviving window, and a /status snapshot.  Best
        effort and bounded — an incident writer error must never reach
        the job, and an alert storm stops at :data:`MAX_INCIDENTS`."""
        if not self.incident_dir:
            return None
        with self._lock:
            if self.incidents_written >= MAX_INCIDENTS:
                if self.incidents_written == MAX_INCIDENTS:
                    self.incidents_written += 1
                    _log.warning("[alert] incident-bundle cap (%d) "
                                 "reached; further firings record to the "
                                 "timeline only", MAX_INCIDENTS)
                return None
            self.incidents_written += 1
            seq = self.incidents_written
        try:
            from map_oxidize_tpu_torch.obs import write_json_atomic

            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
            safe_rule = rule.name.replace("/", "_")
            bundle = os.path.join(
                self.incident_dir,
                f"incident_{stamp}_{safe_rule}_{seq:02d}_{os.getpid()}")
            os.makedirs(bundle, exist_ok=True)
            doc = {
                "schema": INCIDENT_SCHEMA,
                "rule": asdict(rule),
                "series": name,
                "value": float(observed),
                "t_unix_s": round(now, 3),
            }
            if rule.evidence:
                # the cross-linked corroborating metric, read at firing
                # time (gauge first, series ring as fallback) — the
                # responder sees e.g. the critpath straggler-save
                # fraction right next to the skew trigger
                ev_val = None
                reg = getattr(self.obs, "registry", None)
                if reg is not None:
                    ev_val = reg.gauges.get(rule.evidence)
                doc["evidence"] = {"metric": rule.evidence,
                                   "value": ev_val}
            series_rec = getattr(self.obs, "series", None)
            if series_rec is not None:
                export = series_rec.export()
                doc["window"] = {
                    "interval_s": export["interval_s"],
                    "t_unix_s": export["t_unix_s"][-120:],
                    "values": (export["series"].get(name) or [])[-120:],
                }
            if self.config is not None:
                from map_oxidize_tpu_torch.obs.serve import build_status

                doc["status"] = build_status(self.obs, self.config)
            write_json_atomic(os.path.join(bundle, "incident.json"), doc)
            _log.warning("[alert] incident bundle: %s", bundle)
            return bundle
        except Exception as e:  # pragma: no cover - defensive
            _log.warning("incident bundle write failed: %s", e)
            return None

    # --- export -----------------------------------------------------------

    def export(self) -> dict:
        """The ``/alerts`` document (``moxt-alerts-v1``): every rule with
        its per-series states, the currently-firing set, recently
        resolved events, and the bounded timeline.  Snapshot-read under
        the state lock — safe against concurrent ticks and scrapes."""
        now = self._clock()
        with self._lock:
            firing = []
            per_rule: dict[str, list] = {}
            for (rname, series), cell in sorted(self._states.items()):
                row = {"series": series, "state": cell.state,
                       "value": cell.value}
                if cell.state == "firing":
                    row["since_unix_s"] = round(cell.since_unix_s, 3)
                    rule = next((r for r in self.rules
                                 if r.name == rname), None)
                    firing.append({
                        "rule": rname, "series": series,
                        "value": cell.value,
                        "threshold": rule.threshold if rule else None,
                        "op": rule.op if rule else None,
                        "severity": rule.severity if rule else None,
                        "evidence": (rule.evidence or None) if rule
                                    else None,
                        "since_unix_s": round(cell.since_unix_s, 3),
                    })
                per_rule.setdefault(rname, []).append(row)
            resolved = [e for e in self.timeline
                        if e["event"] == "resolved"][-32:]
            timeline = list(self.timeline)
            counts = {"fired": self.fired_total,
                      "resolved": self.resolved_total,
                      "incidents": min(self.incidents_written,
                                       MAX_INCIDENTS)}
        return {
            "schema": ALERTS_SCHEMA,
            "t_unix_s": round(now, 3),
            "interval_s": self.interval_s,
            "counts": counts,
            "firing": firing,
            "resolved": resolved,
            "rules": [dict(asdict(r), states=per_rule.get(r.name, []))
                      for r in self.rules],
            "timeline": timeline,
        }

    def timeline_doc(self) -> dict:
        """The compact form ledger entries carry."""
        with self._lock:
            return {"fired": self.fired_total,
                    "resolved": self.resolved_total,
                    "timeline": list(self.timeline)[-64:]}


def _latest(vals: list) -> tuple[float, int] | None:
    """Newest non-None reading and its index."""
    for i in range(len(vals) - 1, -1, -1):
        if vals[i] is not None:
            return vals[i], i
    return None


def _at_or_before(t: list, vals: list, target: float
                  ) -> tuple[float, int] | None:
    """Newest non-None reading at or before ``target``; falls back to
    the OLDEST surviving reading when the whole ring is younger (the
    wrap-clamp described in the module docstring)."""
    best = None
    for i, ts in enumerate(t):
        if vals[i] is None:
            continue
        if ts <= target:
            best = (vals[i], i)
        else:
            break
    if best is not None:
        return best
    for i, v in enumerate(vals):        # ring younger than the window:
        if v is not None:               # clamp to the oldest sample
            return v, i
    return None
