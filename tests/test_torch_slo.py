"""The port's SLO plane, time series and Prometheus export against the JAX
package's (``obs/slo.py``, ``obs/timeseries.py``, ``obs/serve.py``), on
the CPU: the JAX suite ``tests/test_slo.py`` case by case, each driven
through both packages with the same injected series on the same fake
clock, and held to equal firing/resolved timelines, equal rule sets and
equal Prometheus texts.  The JAX suite's three ``obs trend`` cases are in
``tests/test_torch_trend.py``.
"""

import json
import os
import re
import time
import types
import urllib.request

import pytest

from map_oxidize_tpu import obs as jax_obs_pkg
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import ledger as jax_ledger
from map_oxidize_tpu.obs import metrics as jax_metrics
from map_oxidize_tpu.obs import serve as jax_serve
from map_oxidize_tpu.obs import slo as jax_slo
from map_oxidize_tpu.obs import timeseries as jax_ts
from map_oxidize_tpu.obs import trace as jax_trace
from map_oxidize_tpu.obs.heartbeat import Heartbeat as JaxHeartbeat
from map_oxidize_tpu_torch import obs as port_obs_pkg
from map_oxidize_tpu_torch.config import JobConfig, ServeConfig
from map_oxidize_tpu_torch.obs import ledger as port_ledger
from map_oxidize_tpu_torch.obs import metrics as port_metrics
from map_oxidize_tpu_torch.obs import serve as port_serve
from map_oxidize_tpu_torch.obs import slo as port_slo
from map_oxidize_tpu_torch.obs import timeseries as port_ts
from map_oxidize_tpu_torch.obs import trace as port_trace
from map_oxidize_tpu_torch.obs.heartbeat import Heartbeat

PORT = types.SimpleNamespace(
    Obs=port_obs_pkg.Obs, MetricsRegistry=port_metrics.MetricsRegistry,
    Tracer=port_trace.Tracer, TimeSeriesRecorder=port_ts.TimeSeriesRecorder,
    SloRule=port_slo.SloRule, SloEvaluator=port_slo.SloEvaluator,
    load_rules=port_slo.load_rules, Heartbeat=Heartbeat,
    prometheus_text=port_serve.prometheus_text,
    sanitized_export_names=port_serve.sanitized_export_names,
    LATENCY_BUCKETS_MS=port_metrics.LATENCY_BUCKETS_MS,
    JobConfig=JobConfig, ledger=port_ledger)
JAX = types.SimpleNamespace(
    Obs=jax_obs_pkg.Obs, MetricsRegistry=jax_metrics.MetricsRegistry,
    Tracer=jax_trace.Tracer, TimeSeriesRecorder=jax_ts.TimeSeriesRecorder,
    SloRule=jax_slo.SloRule, SloEvaluator=jax_slo.SloEvaluator,
    load_rules=jax_slo.load_rules, Heartbeat=JaxHeartbeat,
    prometheus_text=jax_serve.prometheus_text,
    sanitized_export_names=jax_serve.sanitized_export_names,
    LATENCY_BUCKETS_MS=jax_metrics.LATENCY_BUCKETS_MS,
    JobConfig=JaxJobConfig, ledger=jax_ledger)
BOTH = (PORT, JAX)


def _write_corpus(path, lines=300):
    with open(path, "wb") as f:
        f.write(b"the quick brown fox jumps over the lazy dog\n" * lines)
    return str(path)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Twin:
    """One fake-clock obs bundle with a series recorder and an evaluator
    per package, driven by the same actions; :meth:`tick` samples both
    rings, evaluates both and asserts equal transition events."""

    def __init__(self, rules, capacity=64, **evkw):
        self.sides = []
        for pkg in BOTH:
            clock = _Clock()
            obs = pkg.Obs(registry=pkg.MetricsRegistry(),
                          tracer=pkg.Tracer(enabled=False))
            obs.tracer.wall_start = clock()
            obs.series = pkg.TimeSeriesRecorder(
                obs.registry, interval_s=1.0, capacity=capacity,
                clock=clock)
            ev = pkg.SloEvaluator(
                obs, [pkg.SloRule(**r).validate() for r in rules],
                clock=clock, **evkw)
            self.sides.append(types.SimpleNamespace(
                pkg=pkg, clock=clock, obs=obs, ev=ev))

    @property
    def port(self):
        return self.sides[0]

    def each(self, fn):
        for side in self.sides:
            fn(side)

    def set(self, name, value):
        self.each(lambda s: s.obs.registry.set(name, value))

    def count(self, name, delta=1):
        self.each(lambda s: s.obs.registry.count(name, delta))

    def advance(self, dt):
        self.each(lambda s: setattr(s.clock, "t", s.clock.t + dt))

    def sample(self):
        self.each(lambda s: s.obs.series.sample_once())

    def evaluate(self, now=None) -> list:
        got = [s.ev.evaluate_once(now=now) for s in self.sides]
        assert got[0] == got[1]
        return got[0]

    def tick(self, dt=0.0) -> list:
        self.advance(dt)
        self.sample()
        return self.evaluate()

    def timelines_equal(self):
        port, ref = self.sides
        assert port.ev.timeline == ref.ev.timeline
        assert port.ev.fired_total == ref.ev.fired_total
        assert port.ev.resolved_total == ref.ev.resolved_total


def _events(evs):
    return [e["event"] for e in evs]


# --- rules ------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_rule_validation_rejects_bad_specs(pkg):
    for kw in ({"kind": "bogus"}, {"op": "=="}, {"scope": "cluster"},
               {"window_s": 0}, {"kind": "delta", "denominator": "d"}):
        with pytest.raises(ValueError):
            pkg.SloRule(name="x", metric="m", **kw).validate()
    with pytest.raises(ValueError):   # unknown field = a typo, not noise
        pkg.load_rules('[{"name": "x", "metric": "m", "treshold": 3}]')


def test_load_rules_extend_replace_override_like_jax():
    specs = [None, '[{"name": "mine", "metric": "m"}]',
             '{"defaults": false, "rules": [{"name": "only", '
             '"metric": "m"}]}',
             '[{"name": "mfu-floor", "metric": "xprof/*/mfu_pct", '
             '"op": "<", "threshold": 40}]']
    for spec in specs:
        got = [r.name for r in port_slo.load_rules(spec)]
        assert got == [r.name for r in jax_slo.load_rules(spec)]
    assert [d["name"] for d in port_slo.DEFAULT_RULES] == \
        [d["name"] for d in jax_slo.DEFAULT_RULES]
    floor = next(r for r in port_slo.load_rules(specs[3])
                 if r.name == "mfu-floor")
    assert floor.threshold == 40
    # every default rule is the JAX rule, field for field (the port's
    # recompile description names no compiler)
    for mine, ref in zip(port_slo.load_rules(None),
                         jax_slo.load_rules(None)):
        a, b = dict(vars(mine)), dict(vars(ref))
        a.pop("description")
        b.pop("description")
        assert a == b


def test_load_rules_from_file(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps([{"name": "f", "metric": "m"}]))
    for pkg in BOTH:
        assert "f" in {r.name for r in pkg.load_rules(str(p))}
        with pytest.raises(OSError):
            pkg.load_rules(str(tmp_path / "missing.json"))
        with pytest.raises(ValueError):
            pkg.JobConfig(input_path="x",
                          slo_rules=str(tmp_path / "missing.json")
                          ).validate()


# --- evaluation: kinds, debounce, arming, wraparound ------------------------


def test_value_rule_fires_and_resolves_like_jax():
    tw = Twin([{"name": "low", "metric": "work/level", "op": "<",
                "threshold": 100}])
    tw.set("work/level", 5)
    events = tw.tick()
    assert _events(events) == ["fired"]
    assert events[0]["rule"] == "low" and events[0]["value"] == 5
    reg = tw.port.obs.registry
    assert reg.counters["alerts/fired"] == 1
    assert reg.gauges["alerts/firing"] == 1
    assert tw.tick(1) == []                  # still firing: no duplicate
    tw.set("work/level", 500)
    assert _events(tw.tick(1)) == ["resolved"]
    assert reg.counters["alerts/resolved"] == 1
    assert reg.gauges["alerts/firing"] == 0
    assert _events(tw.port.ev.timeline) == ["fired", "resolved"]
    tw.timelines_equal()


def test_for_s_debounce_requires_sustained_condition_like_jax():
    tw = Twin([{"name": "slow", "metric": "g", "op": ">", "threshold": 10,
                "for_s": 5.0}])
    tw.set("g", 50)
    assert tw.tick() == []                   # pending, not firing
    assert tw.tick(2) == []                  # still inside for_s
    tw.set("g", 1)                           # a dip resets the debounce
    assert tw.tick(1) == []
    tw.set("g", 50)
    assert tw.tick(1) == []                  # pending restarted
    assert _events(tw.tick(6)) == ["fired"]
    tw.timelines_equal()


def test_after_s_excludes_cold_start_like_jax():
    tw = Twin([{"name": "warmed", "metric": "g", "op": ">", "threshold": 0,
                "after_s": 300}])
    tw.set("g", 5)
    assert tw.tick() == []                   # job too young
    assert _events(tw.tick(301)) == ["fired"]
    tw.timelines_equal()


def test_delta_rule_fires_then_resolves_as_window_passes_like_jax():
    tw = Twin([{"name": "grew", "metric": "c", "kind": "delta", "op": ">",
                "threshold": 0, "window_s": 10}])
    tw.count("c", 1)
    tw.sample()
    tw.advance(5)
    tw.count("c", 3)
    tw.sample()
    assert _events(tw.evaluate()) == ["fired"]
    assert _events(tw.tick(20)) == ["resolved"]
    tw.timelines_equal()


def test_delta_rule_fires_on_first_increment_of_lazy_counter_like_jax():
    tw = Twin([{"name": "stall", "metric": "heartbeat/stalls",
                "kind": "delta", "op": ">", "threshold": 0,
                "window_s": 120}])
    for _ in range(3):
        tw.sample()
        tw.advance(1)
    assert tw.evaluate() == []               # series absent: nothing
    tw.count("heartbeat/stalls", 1)          # THE first episode
    tw.sample()
    events = tw.evaluate()
    assert _events(events) == ["fired"] and events[0]["value"] == 1.0


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_rule_numeric_fields_type_checked_at_config_time(pkg):
    with pytest.raises(ValueError):
        pkg.load_rules('[{"name": "x", "metric": "m", "threshold": "5000"}]')
    with pytest.raises(ValueError):
        pkg.load_rules('[{"name": "x", "metric": "m", "window_s": "60"}]')
    with pytest.raises(ValueError):
        pkg.JobConfig(input_path="x", slo_rules='[{"name": "x", "metric": '
                      '"m", "threshold": "5000"}]').validate()


def test_scope_filters_serve_rules_off_jobs_like_jax():
    tw = Twin([{"name": "s", "metric": "g", "op": ">", "threshold": 0,
                "scope": "serve"}])
    tw.set("g", 5)
    assert tw.tick() == []                   # job scope: serve rule off
    tw.each(lambda s: setattr(s.obs, "workload", "serve"))
    assert _events(tw.evaluate()) == ["fired"]


def test_denominator_rule_dormant_until_budget_exists_like_jax():
    tw = Twin([{"name": "hbm", "metric": "hbm/live_bytes_*", "op": ">",
                "threshold": 0.95, "denominator": "hbm/budget_bytes"}])
    tw.set("hbm/live_bytes_device0", 96)
    assert tw.tick() == []                   # no budget gauge yet
    tw.set("hbm/budget_bytes", 100)
    events = tw.tick(1)
    assert _events(events) == ["fired"]
    assert events[0]["value"] == pytest.approx(0.96)


def test_rate_rule_correct_across_ring_wraparound_like_jax():
    tw = Twin([{"name": "rate", "metric": "c", "kind": "rate", "op": ">",
                "threshold": 4.9, "window_s": 1000}], capacity=4)
    for _ in range(10):                      # 5 units/s for 10 s
        tw.count("c", 5)
        tw.sample()
        tw.advance(1)
    port = tw.port.obs.series
    assert port.samples_taken == 10
    export = port.export()
    assert len(export["t_unix_s"]) == 4
    assert export == tw.sides[1].obs.series.export()
    events = tw.evaluate(now=tw.port.clock.t)
    assert _events(events) == ["fired"]
    assert events[0]["value"] == pytest.approx(5.0)


def test_series_capacity_env_hook(tmp_path, monkeypatch):
    """MOXT_SERIES_CAPACITY shrinks the ring in both packages."""
    monkeypatch.setenv("MOXT_SERIES_CAPACITY", "8")
    corpus = _write_corpus(tmp_path / "c.txt", lines=5)
    for pkg in BOTH:
        cfg = pkg.JobConfig(input_path=corpus, output_path="",
                            obs_sample_s=0.01).validate()
        obs = pkg.Obs.from_config(cfg)
        try:
            assert obs.series.capacity == 8
            for _ in range(20):
                obs.series.sample_once()
            assert len(obs.series.export()["t_unix_s"]) == 8
        finally:
            obs.finish(cfg, "wordcount")


# --- incidents --------------------------------------------------------------


def test_incident_bundle_and_cap_like_jax(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt", lines=3)
    rule = [{"name": "inc/rule", "metric": "g", "op": ">", "threshold": 0}]
    tw = Twin(rule)
    for side, name in zip(tw.sides, ("port", "jax")):
        side.ev.config = side.pkg.JobConfig(input_path=corpus,
                                            output_path="").validate()
        side.ev.incident_dir = str(tmp_path / name)
    tw.set("g", 7)
    assert _events(tw.tick()) == ["fired"]
    docs = []
    for name in ("port", "jax"):
        (bundle,) = os.listdir(tmp_path / name)
        assert bundle.startswith("incident_") and "inc_rule" in bundle
        with open(tmp_path / name / bundle / "incident.json") as f:
            docs.append(json.load(f))
    mine, ref = docs
    assert set(mine) == set(ref)
    assert mine["schema"] == "moxt-incident-v1"
    assert mine["rule"] == ref["rule"] and mine["value"] == 7
    assert mine["window"] == ref["window"]
    assert mine["status"]["schema"] == "moxt-status-v1"
    # the cap: an alert storm stops writing bundles, keeps counting
    tw.each(lambda s: setattr(s.ev, "incidents_written",
                              port_slo.MAX_INCIDENTS))
    tw.set("g", 0)
    tw.tick(1)                               # resolved
    tw.set("g", 9)
    assert _events(tw.tick(1)) == ["fired"]
    assert tw.port.ev.fired_total == 2
    assert len(os.listdir(tmp_path / "port")) == 1
    tw.timelines_equal()


# --- announcement + export --------------------------------------------------


def test_alert_lines_ride_the_heartbeat_like_jax():
    tw = Twin([{"name": "loud", "metric": "g", "op": ">", "threshold": 0}])
    lines = {}
    for side in tw.sides:
        got = lines[side.pkg is PORT] = []
        side.obs.heartbeat = side.pkg.Heartbeat(
            interval_s=10.0, clock=side.clock, emit=got.append)
    tw.set("g", 3)
    tw.tick()
    tw.set("g", 0)
    tw.tick(1)
    assert lines[True] == lines[False]
    assert any("[alert] FIRING loud" in line for line in lines[True])
    assert any("[alert] resolved loud" in line for line in lines[True])


def test_alerts_export_renders_in_the_jax_top_panel():
    """The port's ``/alerts`` document equals the JAX one and renders in
    the JAX package's ``obs top`` panel."""
    from map_oxidize_tpu.obs.cli import render_alerts

    tw = Twin([{"name": "a", "metric": "g", "op": ">", "threshold": 1},
               {"name": "b", "metric": "h", "op": ">", "threshold": 1,
                "severity": "critical"}])
    tw.set("g", 5)
    tw.set("h", 5)
    tw.tick()
    tw.set("h", 0)
    tw.tick(1)
    doc = tw.port.ev.export()
    assert doc == tw.sides[1].ev.export()
    assert doc["schema"] == "moxt-alerts-v1"
    assert doc["counts"] == {"fired": 2, "resolved": 1, "incidents": 0}
    assert [f["rule"] for f in doc["firing"]] == ["a"]
    assert [r["rule"] for r in doc["resolved"]] == ["b"]
    frame = render_alerts(doc)
    assert "1 firing" in frame and "!! WARNING  a: g=5" in frame


# --- ledger gate ------------------------------------------------------------


def _entry(ts, metrics, workload="wc", phases=None):
    return {"ts_unix_s": ts, "version": "1", "config_hash": "cfg",
            "workload": workload, "corpus_bytes": 1000, "n_processes": 1,
            "phases_s": dict(phases or {"map+reduce": 1.0}),
            "metrics": dict(metrics)}


def test_ledger_diff_flags_alert_firing_like_jax():
    a = _entry(1, {"alerts/fired": 0})
    b = _entry(2, {"alerts/fired": 2})
    for x, y in ((a, b), (b, _entry(3, {"alerts/fired": 2}))):
        diff = port_ledger.diff_entries(x, y)
        assert diff == jax_ledger.diff_entries(x, y)
    assert any("SLO alerts fired" in r
               for r in port_ledger.diff_entries(a, b)["regressions"])


# --- prometheus export ------------------------------------------------------


def test_sanitized_name_collision_guard_like_jax():
    entries = [("counter", "comms/a/b/bytes"), ("gauge", "comms/a_b/bytes"),
               ("counter", "x+y"), ("counter", "x-y")]
    names = port_serve.sanitized_export_names(entries)
    assert names == jax_serve.sanitized_export_names(entries)
    assert len(set(names.values())) == len(entries)
    assert names == port_serve.sanitized_export_names(
        list(reversed(entries)))
    assert names[("counter", "comms/a/b/bytes")] == "moxt_comms_a_b_bytes"


def test_prometheus_names_sticky_across_scrapes_like_jax():
    texts = []
    for pkg in BOTH:
        reg = pkg.MetricsRegistry()
        reg.count("comms/a_b/bytes", 5)
        first = pkg.prometheus_text(reg)
        reg.count("comms/a/b/bytes", 7)
        second = pkg.prometheus_text(reg)
        assert pkg.prometheus_text(reg) == second
        texts.append((first, second))
    assert texts[0] == texts[1]
    first, second = texts[0]
    assert "moxt_comms_a_b_bytes 5" in first
    assert "moxt_comms_a_b_bytes 5" in second
    assert "moxt_comms_a_b_bytes_x" in second


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+inf-]+$")


def _parse_prom(text: str) -> dict:
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
        key, val = line.rsplit(" ", 1)
        out[key] = float(val) if val != "+Inf" else float("inf")
    return out


def test_prometheus_histogram_buckets_parse_and_cumulate_like_jax():
    texts = []
    for pkg in BOTH:
        reg = pkg.MetricsRegistry()
        for v in (3.0, 30.0, 300.0, 3000.0, 10_000_000.0):
            reg.observe("serve/queue_wait_ms", v,
                        buckets=pkg.LATENCY_BUCKETS_MS)
        texts.append((pkg.prometheus_text(reg),
                      pkg.prometheus_text(reg, {"process": "1"})))
    assert texts[0] == texts[1]
    series = _parse_prom(texts[0][0])
    assert series['moxt_serve_queue_wait_ms_hist_bucket{le="+Inf"}'] == 5.0
    assert series['moxt_serve_queue_wait_ms_hist_bucket{le="5"}'] == 1.0
    assert series["moxt_serve_queue_wait_ms_hist_sum"] == pytest.approx(
        10_003_333.0)
    assert 'le="+Inf",process="1"' in texts[0][1]


# --- serve: per-job latency histograms --------------------------------------


def _instant_runner(pkg, compiles=0):
    def run(config, workload, on_obs):
        obs = pkg.Obs.from_config(config)
        on_obs(obs)
        with obs.recording(config, workload):
            pass
        obs.finish(config, workload)

        class _R:
            metrics = {"records_in": 1,
                       "compile/total_compiles": compiles}

        return _R()

    return run


def test_scheduler_records_latency_histograms_and_warm_compiles(tmp_path):
    """Three instant jobs through each package's scheduler: the same
    server-registry histograms and counters (the port adds only its
    ``kernels/<name>/launches`` gauges)."""
    from map_oxidize_tpu.config import ServeConfig as JaxServeConfig
    from map_oxidize_tpu.serve.scheduler import Scheduler as JaxScheduler
    from map_oxidize_tpu_torch.serve.scheduler import Scheduler

    corpus = _write_corpus(tmp_path / "c.txt", lines=5)
    regs = []
    for pkg, sched_cls, cfg_cls in ((PORT, Scheduler, ServeConfig),
                                    (JAX, JaxScheduler, JaxServeConfig)):
        cfg = cfg_cls(spool_dir=str(tmp_path / f"spool{len(regs)}"),
                      workers=1, job_sample_s=0.0,
                      drain_timeout_s=5.0).validate()
        sched = sched_cls(cfg, runner=_instant_runner(pkg, compiles=2))
        reg = pkg.MetricsRegistry()
        sched.server_registry = reg
        sched.start()
        try:
            jobs = [sched.submit("wordcount", corpus) for _ in range(3)]
            for j in jobs:
                assert sched.wait(j.id, timeout=30).state == "done"
            assert sched.job_doc(jobs[0].id)["queue_wait_s"] >= 0
        finally:
            sched.shutdown()
        regs.append(reg)
    mine, ref = regs
    assert set(mine.histograms) == set(ref.histograms)
    assert mine.counters == ref.counters
    assert mine.counters["serve/warm_compiles"] == 4
    assert {k for k in mine.gauges if not k.startswith("kernels/")} == \
        set(ref.gauges)
    assert mine.gauges["kernels/kmeans_assign_sum/launches"] == 0
    hq = mine.histograms["serve/queue_wait_ms"]
    assert hq.buckets == tuple(port_metrics.LATENCY_BUCKETS_MS)
    assert hq.cumulative_buckets()[-1] == (float("inf"), 3)
    series = _parse_prom(port_serve.prometheus_text(mine))
    assert series["moxt_serve_run_wall_ms_hist_count"] == 3.0


# --- end-to-end: injected rule on a live job --------------------------------


def test_injected_rule_fires_and_resolves_live(tmp_path):
    """An injected rule fires mid-run on the port's live plane — at
    /alerts, rendered by the JAX ``obs top`` panel, and as an incident
    bundle — then resolves; the exported timeline carries both."""
    from map_oxidize_tpu.obs.cli import render_alerts

    corpus = _write_corpus(tmp_path / "c.txt", lines=50)
    rule = json.dumps({"defaults": False, "rules": [
        {"name": "rows-floor", "metric": "progress/rows", "op": "<",
         "threshold": 50, "kind": "value"}]})
    cfg = JobConfig(input_path=corpus, output_path="", backend="cpu",
                    obs_port=0, obs_sample_s=0.02, slo_rules=rule,
                    metrics_out=str(tmp_path / "metrics.json"),
                    crash_dir=str(tmp_path / "crash")).validate()
    obs = port_obs_pkg.Obs.from_config(cfg)

    def _get(ep):
        return json.loads(urllib.request.urlopen(
            f"{obs.server.url}{ep}", timeout=5).read())

    deadline = time.monotonic() + 30
    with obs.recording(cfg, "wordcount"):
        doc = None
        while time.monotonic() < deadline:   # rows=0 < 50: must fire
            doc = _get("/alerts")
            if doc["firing"]:
                break
            time.sleep(0.01)
        assert doc["firing"] and doc["firing"][0]["rule"] == "rows-floor"
        assert "rows-floor" in render_alerts(doc)
        assert "/alerts" in _get("/")["endpoints"]
        obs.heartbeat.update(rows=500)       # condition clears
        while time.monotonic() < deadline:
            doc = _get("/alerts")
            if not doc["firing"] and doc["counts"]["resolved"]:
                break
            time.sleep(0.01)
        assert not doc["firing"] and doc["counts"]["resolved"] == 1
    obs.finish(cfg, "wordcount")
    with open(tmp_path / "metrics.json") as f:
        out = json.load(f)
    assert [e["event"] for e in out["alerts"]["timeline"]] == [
        "fired", "resolved"]
    assert out["counters"]["alerts/fired"] == 1
    assert any(d.startswith("incident_")
               for d in os.listdir(tmp_path / "crash"))


def test_default_rules_silent_on_healthy_run(tmp_path):
    """A healthy word count with the series on fires no default rule in
    either package, and both documents carry the same series names."""
    from map_oxidize_tpu.runtime import run_job as jax_run_job
    from map_oxidize_tpu_torch.runtime import run_job

    corpus = _write_corpus(tmp_path / "c.txt", lines=200)
    docs = []
    for name, run, cfg_cls, kw in (
            ("t", run_job, JobConfig, {"backend": "cpu"}),
            ("j", jax_run_job, JaxJobConfig, {"num_shards": 1})):
        cfg = cfg_cls(input_path=corpus,
                      output_path=str(tmp_path / f"{name}_out.txt"),
                      num_chunks=4, obs_sample_s=0.01, metrics=False,
                      metrics_out=str(tmp_path / f"{name}.json"),
                      **kw).validate()
        run(cfg, "wordcount")
        with open(tmp_path / f"{name}.json") as f:
            docs.append(json.load(f))
    for doc in docs:
        assert doc["alerts"]["counts"]["fired"] == 0
        assert doc["alerts"]["timeline"] == []
        assert "alerts/fired" not in doc["counters"]
    assert set(docs[0]["alerts"]) == set(docs[1]["alerts"])
    assert set(docs[0]["series"]) == set(docs[1]["series"])
    assert "progress/rows" in docs[0]["series"]["series"]


def test_crash_bundle_carries_alert_timeline(tmp_path):
    """An abort mid-alert lands the firing state in the port's flight
    bundle, with the JAX bundle's ``alerts`` keys."""
    corpus = _write_corpus(tmp_path / "c.txt", lines=5)
    rule = json.dumps({"defaults": False, "rules": [
        {"name": "always", "metric": "boom/level", "op": ">",
         "threshold": 0}]})
    cfg = JobConfig(input_path=corpus, output_path="", obs_sample_s=0.02,
                    slo_rules=rule,
                    crash_dir=str(tmp_path / "crash")).validate()
    obs = port_obs_pkg.Obs.from_config(cfg)
    with pytest.raises(RuntimeError):
        with obs.recording(cfg, "wordcount"):
            obs.registry.set("boom/level", 9)
            deadline = time.monotonic() + 20
            while obs.alerts.fired_total == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert obs.alerts.fired_total == 1
            raise RuntimeError("abort with an alert firing")
    (bundle,) = [d for d in os.listdir(tmp_path / "crash")
                 if d.startswith("crash_")]
    with open(tmp_path / "crash" / bundle / "metrics.json") as f:
        doc = json.load(f)
    assert doc["alerts"]["counts"]["fired"] == 1
    assert doc["alerts"]["firing"][0]["rule"] == "always"
    assert doc["series"]["schema"] == "moxt-series-v1"
    ref = jax_slo.SloEvaluator(types.SimpleNamespace(), []).export()
    assert set(doc["alerts"]) == set(ref)
