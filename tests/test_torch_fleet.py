"""The port's fleet observatory (``obs/fleet.py``, ``FleetConfig``) case by
case against the JAX suite ``tests/test_fleet.py`` (21 cases, the same
names): the multi-endpoint collector over the port's ``ObsServer`` and
resident server, per-target staleness, fleet SLOs and cross-target
incident correlation, the labelled fleet ``/metrics``, target discovery
(explicit / port file / serve spool / well-known spool) and the
persistent series archive with its post-mortem readers.  Then the wire
formats across the packages: a collector of either package over the
other's ``ObsServer``, and an archive of either package read by the
other's ``obs trend/top/where --archive``.

Collector sweeps are driven through ``poll_once`` with an injected clock,
so staleness windows and alert transitions are deterministic, with no
wall-clock sleeps on the model paths.  The endpoints scraped are real
``ObsServer``/stub HTTP servers on ephemeral localhost ports.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from map_oxidize_tpu_torch.config import FleetConfig, JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs import fleet as fleet_mod
from map_oxidize_tpu_torch.obs.fleet import (
    ArchiveMismatch,
    FleetCollector,
    FleetServer,
    SeriesArchive,
    correlate_alerts,
    discover_targets,
)


class _Clock:
    """Injectable fleet time: staleness windows advance by assignment,
    never by sleeping."""

    def __init__(self, t0: float = 1_000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t


def _fleet_cfg(**kw) -> FleetConfig:
    kw.setdefault("discover_dir", "none")
    kw.setdefault("poll_interval_s", 0.5)
    kw.setdefault("stale_after_s", 5.0)
    return FleetConfig(**kw).validate()


@pytest.fixture()
def job_server(tmp_path, monkeypatch):
    """One real obs server over a live job-shaped bundle (ephemeral
    port), spool publishing routed into the test's tmpdir."""
    monkeypatch.setenv("MOXT_OBS_SPOOL", str(tmp_path / "wkspool"))
    cfg = JobConfig(input_path=str(tmp_path / "x"), obs_port=0,
                    obs_sample_s=0.05).validate()
    obs = Obs.from_config(cfg)
    obs.workload = "wordcount"
    yield obs
    obs.stop_live()
    obs.finish_xprof()


# --- config -----------------------------------------------------------------


def test_fleet_config_validates():
    with pytest.raises(ValueError):
        FleetConfig(port=70000).validate()
    with pytest.raises(ValueError):
        FleetConfig(poll_interval_s=0).validate()
    with pytest.raises(ValueError):
        FleetConfig(stale_after_s=0).validate()
    with pytest.raises(ValueError):
        FleetConfig(archive_max_segments=1).validate()
    with pytest.raises(ValueError, match="invalid fleet slo_rules"):
        FleetConfig(slo_rules='[{"metric": "x"}]').validate()
    # fleet defaults are tunable by name, like any rule set
    cfg = FleetConfig(slo_rules='[{"name": "fleet-target-stale", '
                                '"metric": "fleet/target/*/stale", '
                                '"threshold": 2}]').validate()
    from map_oxidize_tpu_torch.obs.fleet import FLEET_RULES
    from map_oxidize_tpu_torch.obs.slo import load_rules

    rules = {r.name: r for r in load_rules(cfg.slo_rules,
                                           defaults=FLEET_RULES)}
    assert rules["fleet-target-stale"].threshold == 2
    assert "fleet-hbm-watermark" in rules


# --- the series archive -----------------------------------------------------


def test_archive_ring_bounds_and_export(tmp_path):
    root = str(tmp_path / "arch")
    arch = SeriesArchive(root, segment_records=4, max_segments=2)
    for i in range(20):
        arch.append(100.0 + i, {"fleet/rows_per_sec": float(i)})
    arch.close()
    samples = SeriesArchive.samples(root)
    # bounded: at most segment_records * max_segments survive, and the
    # survivors are the NEWEST samples in order
    assert len(samples) <= 8
    vals = [v["fleet/rows_per_sec"] for _t, v in samples]
    assert vals == sorted(vals)
    assert vals[-1] == 19.0
    export = SeriesArchive.export(root)
    assert export["schema"] == "moxt-archive-v1"
    assert len(export["t_unix_s"]) == len(samples)
    assert export["series"]["fleet/rows_per_sec"][-1] == 19.0


def test_archive_resume_and_latest(tmp_path):
    root = str(tmp_path / "arch")
    arch = SeriesArchive(root, segment_records=4, max_segments=3)
    for i in range(3):
        arch.append(float(i), {"c": i})
    arch.write_latest("status", {"schema": "moxt-fleet-status-v1",
                                 "counts": {"targets": 2}})
    arch.close()
    # a second collector resumes the ring instead of refusing/clobbering
    arch2 = SeriesArchive(root, segment_records=4, max_segments=3)
    arch2.append(3.0, {"c": 3})
    arch2.close()
    assert [v["c"] for _t, v in SeriesArchive.samples(root)] == [0, 1, 2, 3]
    assert SeriesArchive.latest(root, "status")["counts"]["targets"] == 2
    assert SeriesArchive.latest(root, "alerts") is None


def test_archive_schema_refusal(tmp_path):
    from map_oxidize_tpu_torch.cli import main

    root = str(tmp_path / "arch")
    arch = SeriesArchive(root)
    arch.append(1.0, {"c": 1})
    arch.close()
    meta = json.loads((tmp_path / "arch" / "archive.json").read_text())
    meta["schema"] = "moxt-archive-v99"
    (tmp_path / "arch" / "archive.json").write_text(json.dumps(meta))
    with pytest.raises(ArchiveMismatch, match="moxt-archive-v99"):
        SeriesArchive.samples(root)
    with pytest.raises(ArchiveMismatch):
        SeriesArchive(root)              # a writer refuses it too
    assert main(["obs", "trend", "--archive", root]) == 2
    assert main(["obs", "top", "--archive", root]) == 2


# --- discovery --------------------------------------------------------------


def test_discovery_sources(tmp_path):
    portfile = tmp_path / "ports.txt"
    portfile.write_text("0 8101\n1 8102\nnot a line\n")
    spool = tmp_path / "serve_spool"
    spool.mkdir()
    (spool / "obs_port.json").write_text(json.dumps({
        "schema": "moxt-obs-port-v1", "pid": os.getpid(),
        "url": "http://127.0.0.1:8203"}))
    cfg = _fleet_cfg(targets=["127.0.0.1:8001", "http://127.0.0.1:8002/"],
                     port_file=str(portfile), spool_dirs=[str(spool)])
    found = discover_targets(cfg)
    assert found["127.0.0.1:8001"]["explicit"]
    assert found["127.0.0.1:8002"]["url"] == "http://127.0.0.1:8002"
    assert found["127.0.0.1:8101"]["source"] == "portfile"
    assert found["127.0.0.1:8102"]["source"] == "portfile"
    assert found["127.0.0.1:8203"]["source"] == "spool"
    # a malformed spool record is skipped, never fatal
    (spool / "obs_port.json").write_text("{broken")
    assert "127.0.0.1:8203" not in discover_targets(cfg)


def test_discovery_well_known_spool_gc(tmp_path):
    """Dead-pid records: never a target when unwatched, KEPT on disk
    while fresh (another collector sharing the spool may be watching
    that target — a kill must read as stale, not as a clean departure),
    garbage-collected only once genuinely old, and always kept when
    THIS collector watches the label."""
    import time as _time

    from map_oxidize_tpu_torch.obs.fleet import GC_GRACE_S

    spool = tmp_path / "spool"
    spool.mkdir()

    def _record(name, pid, port):
        (spool / name).write_text(json.dumps({
            "schema": "moxt-obs-port-v1", "pid": pid,
            "url": f"http://127.0.0.1:{port}"}))

    _record("moxt-obs-1-p0.json", 2 ** 22 + 1234567, 8301)  # dead pid
    _record(f"moxt-obs-{os.getpid()}-p0.json", os.getpid(), 8302)
    cfg = _fleet_cfg(discover_dir=str(spool))
    found = discover_targets(cfg)
    assert "127.0.0.1:8301" not in found          # dead: not a target
    assert (spool / "moxt-obs-1-p0.json").exists()  # fresh: kept
    assert found["127.0.0.1:8302"]["source"] == "discovered"
    # past the grace age the unwatched dead record is collected
    old = _time.time() - GC_GRACE_S - 60
    os.utime(spool / "moxt-obs-1-p0.json", (old, old))
    found = discover_targets(cfg)
    assert "127.0.0.1:8301" not in found
    assert not (spool / "moxt-obs-1-p0.json").exists()
    # the same old dead record, for a label the collector DOES watch,
    # stays listed AND on disk
    _record("moxt-obs-1-p0.json", 2 ** 22 + 1234567, 8301)
    os.utime(spool / "moxt-obs-1-p0.json", (old, old))
    found = discover_targets(cfg, known={"127.0.0.1:8301"})
    assert "127.0.0.1:8301" in found
    assert (spool / "moxt-obs-1-p0.json").exists()


def test_discovery_skips_collector_port_lines(tmp_path):
    """A collector's own 'fleet <port>' MOXT_OBS_PORT_FILE line is not a
    target — a collector sharing a run's port file must not discover
    itself and refuse its own fleet-schema payload every sweep."""
    portfile = tmp_path / "ports.txt"
    portfile.write_text("0 8101\nfleet 8999\n")
    found = discover_targets(_fleet_cfg(port_file=str(portfile)))
    assert "127.0.0.1:8101" in found
    assert "127.0.0.1:8999" not in found


def test_obs_server_publishes_and_departs(tmp_path, monkeypatch):
    """Satellite: every serving process publishes its port record at the
    well-known spool — a 2-process run appears as two targets with no
    flags — and a CLEAN stop removes the record, which the collector
    models as departure (not staleness)."""
    spool = tmp_path / "spool"
    monkeypatch.setenv("MOXT_OBS_SPOOL", str(spool))
    from map_oxidize_tpu_torch.obs.serve import ObsServer

    # the port's Obs.from_config has no process slot until the
    # multi-process drivers (ROADMAP A8): two bundles take slots 0 and 1
    # of a 2-process run by hand, each with its own server
    cfg = JobConfig(input_path=str(tmp_path / "x"),
                    obs_sample_s=0.05).validate()
    bundles = []
    for i in range(2):
        b = Obs.from_config(cfg)
        b.process, b.n_processes = i, 2
        b.server = ObsServer(b, cfg, 0)
        b.server.start()
        bundles.append(b)
    for b in bundles:
        b.workload = "wordcount"
    records = sorted(spool.glob("moxt-obs-*.json"))
    assert len(records) == 2
    recs = [json.loads(p.read_text()) for p in records]
    assert {r["process"] for r in recs} == {0, 1}
    assert all(r["schema"] == "moxt-obs-port-v1" for r in recs)

    clock = _Clock()
    col = FleetCollector(_fleet_cfg(discover_dir=str(spool)),
                         clock=clock)
    doc = col.poll_once(now=clock.t)
    assert doc["counts"] == {"targets": 2, "up": 2, "stale": 0,
                             "departed": 0}
    # clean stop removes the record -> departed, NOT stale (no alert)
    bundles[0].stop_live()
    clock.t += 60
    doc = col.poll_once(now=clock.t)
    states = {t["target"]: t["state"] for t in doc["targets"]}
    assert sorted(states.values()) == ["departed", "up"]
    assert col.alerts.fired_total == 0
    for b in bundles:
        b.stop_live()
        b.finish_xprof()


# --- live merge + the fleet plane -------------------------------------------


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def test_collector_merges_live_target(job_server, tmp_path):
    obs = job_server
    obs.registry.set("hbm/live_bytes_device0", 1 << 20)
    obs.registry.set("hbm/budget_bytes", 1 << 21)
    clock = _Clock()
    col = FleetCollector(
        _fleet_cfg(targets=[obs.server.url],
                   archive_dir=str(tmp_path / "arch")), clock=clock)
    doc = col.poll_once(now=clock.t)
    (row,) = doc["targets"]
    assert row["state"] == "up" and row["kind"] == "job"
    assert row["workload"] == "wordcount"
    assert row["version"] == doc["version"]  # same package, no refusal
    assert row["hbm_bytes"] == 1 << 20
    assert row["hbm_frac"] == 0.5
    assert doc["aggregates"]["hbm_max_bytes"] == 1 << 20
    assert doc["aggregates"]["targets_up"] == 1
    # the flat spellings ride the registry -> the series ring the SLO
    # evaluator globs
    assert col.series.latest_names()
    label = row["target"]
    assert f"fleet/target/{label}/up" in col.series.latest_names()
    # the fleet plane serves it all
    srv = FleetServer(col, 0).start()
    try:
        status = _get_json(srv.url + "/status")
        assert status["schema"] == "moxt-fleet-status-v1"
        hz = _get_json(srv.url + "/healthz")
        assert hz["schema"] == "moxt-healthz-v1"
        assert hz["workload"] == "fleet" and hz["targets"] == 1
        alerts = _get_json(srv.url + "/alerts")
        assert alerts["schema"] == "moxt-fleet-alerts-v1"
        assert alerts["incidents"] == []
        series = _get_json(srv.url + "/series")
        assert series["schema"] == "moxt-series-v1"
        import urllib.request

        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
        assert f'moxt_fleet_target_up{{target="{label}"}} 1' in text
        assert f'moxt_fleet_target_hbm_bytes{{target="{label}"}}' in text
        # fleet aggregates export flat beside the labeled series
        assert "moxt_fleet_rows_per_sec" in text
        assert "moxt_fleet_hbm_max_bytes" in text
    finally:
        srv.stop()


def test_target_death_fires_and_resolves(job_server, tmp_path):
    """The resilience contract: a target dying mid-watch becomes a stale
    row + a fleet alert + ONE correlated incident — and the alert
    resolves when the target returns on the same port."""
    from map_oxidize_tpu_torch.obs.serve import ObsServer

    obs = job_server
    port = obs.server.port
    clock = _Clock()
    col = FleetCollector(
        _fleet_cfg(targets=[obs.server.url], stale_after_s=5.0,
                   archive_dir=str(tmp_path / "arch")), clock=clock)
    doc = col.poll_once(now=clock.t)
    assert doc["targets"][0]["state"] == "up"
    # kill the endpoint (the discovery record is irrelevant: the target
    # is explicit, so it can never depart)
    obs.server.stop()
    clock.t += 2
    doc = col.poll_once(now=clock.t)
    assert doc["targets"][0]["state"] == "down"   # inside the window
    assert col.alerts.fired_total == 0
    clock.t += 10                                 # past stale_after_s
    doc = col.poll_once(now=clock.t)
    assert doc["targets"][0]["state"] == "stale"
    assert doc["targets"][0]["staleness_s"] > 5
    assert col.registry.counters["fleet/scrape_errors"] >= 2
    alerts = col.alerts_doc(now=clock.t)
    (inc,) = [i for i in alerts["incidents"]
              if i["rule"] == "fleet-target-stale"]
    assert inc["active"] and inc["k"] == 1
    assert inc["targets"] == [doc["targets"][0]["target"]]
    assert col.alerts.fired_total == 1
    # an incident bundle landed under the archive
    import glob as _glob

    assert _glob.glob(str(tmp_path / "arch" / "incidents" /
                          "incident_*" / "incident.json"))
    # the target returns on the SAME port -> resolves next sweep
    revived = ObsServer(obs, JobConfig(
        input_path=str(tmp_path / "x"), obs_spool="none").validate(),
        port)
    revived.start()
    try:
        clock.t += 2
        doc = col.poll_once(now=clock.t)
        assert doc["targets"][0]["state"] == "up"
        assert col.alerts.resolved_total == 1
        events = [e["event"] for e in col.alerts.timeline]
        assert events == ["fired", "resolved"]
    finally:
        revived.stop()


# --- refusal ----------------------------------------------------------------


class _StubHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        body = self.server.payload
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


def _stub_server(payload: bytes):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    httpd.daemon_threads = True
    httpd.payload = payload
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_malformed_and_mismatched_payloads_refused(job_server):
    """A version-mismatched or garbage payload is counted
    (``fleet/scrape_refused``) and NEVER merged: the model keeps the
    last good document, and persistent refusal runs out the staleness
    clock exactly like unreachability."""
    obs = job_server
    good = json.dumps(_get_json(obs.server.url + "/status")).encode()
    httpd, url = _stub_server(good)
    try:
        clock = _Clock()
        col = FleetCollector(_fleet_cfg(targets=[url], stale_after_s=5.0),
                             clock=clock)
        doc = col.poll_once(now=clock.t)
        assert doc["targets"][0]["state"] == "up"
        good_phase = doc["targets"][0]["phase"]
        # flip to a version-mismatched schema: refused, model untouched
        httpd.payload = json.dumps(
            {"schema": "moxt-status-v99", "phase": "evil"}).encode()
        clock.t += 1
        doc = col.poll_once(now=clock.t)
        row = doc["targets"][0]
        assert row["state"] == "down"
        assert row["scrape_refused"] == 1
        assert "moxt-status-v99" in row["last_error"]
        assert row["phase"] == good_phase          # never merged
        assert col.registry.counters["fleet/scrape_refused"] == 1
        # raw garbage refuses too (malformed, not a transport error)
        httpd.payload = b"<html>not json</html>"
        clock.t += 1
        col.poll_once(now=clock.t)
        assert col.registry.counters["fleet/scrape_refused"] == 2
        assert col.registry.counters.get("fleet/scrape_errors") is None
        # persistent refusal -> stale, and the refusal delta rule fired
        clock.t += 10
        doc = col.poll_once(now=clock.t)
        assert doc["targets"][0]["state"] == "stale"
        fired = {e["rule"] for e in col.alerts.timeline
                 if e["event"] == "fired"}
        assert fired == {"fleet-target-stale", "fleet-scrape-refused"}
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_non_http_garbage_target_never_aborts_sweep():
    """A reclaimed port speaking non-HTTP (BadStatusLine territory) is
    an unreachable-target model state, never an escaped exception that
    would abort every sweep and blind the whole fleet."""
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]

    def _garbage():
        try:
            conn, _addr = srv.accept()
            conn.sendall(b"I AM NOT HTTP\r\n\r\n")
            conn.close()
        except OSError:
            pass

    t = threading.Thread(target=_garbage, daemon=True)
    t.start()
    try:
        clock = _Clock()
        col = FleetCollector(_fleet_cfg(targets=[f"127.0.0.1:{port}"]),
                             clock=clock)
        doc = col.poll_once(now=clock.t)      # must not raise
        assert doc["targets"][0]["state"] == "down"
        assert col.registry.counters["fleet/scrape_errors"] >= 1
    finally:
        srv.close()


def test_hbm_frac_zeroes_when_target_dies(job_server):
    """The per-target HBM fraction is refreshed from CURRENT evidence:
    a target that dies with a high watermark must not leave the gauge
    frozen where the fleet-hbm-watermark rule fires forever (the
    staleness rule owns dead targets)."""
    obs = job_server
    obs.registry.set("hbm/live_bytes_device0", 96)
    obs.registry.set("hbm/budget_bytes", 100)
    clock = _Clock()
    col = FleetCollector(_fleet_cfg(targets=[obs.server.url]),
                         clock=clock)
    doc = col.poll_once(now=clock.t)
    (row,) = doc["targets"]
    label = row["target"]
    assert row["hbm_frac"] == 0.96
    obs.server.stop()
    clock.t += 1
    doc = col.poll_once(now=clock.t)
    assert doc["targets"][0]["hbm_frac"] == 0.0
    assert col.registry.gauges[f"fleet/target/{label}/hbm_frac"] == 0.0


# --- correlation ------------------------------------------------------------


def test_correlate_alerts_collapses_rule_across_targets():
    """The same rule firing on k targets within the window is ONE fleet
    incident naming all k — firing states and recent 'fired' timeline
    events both join; stale events outside the window do not."""
    now = 10_000.0
    a = {"firing": [{"rule": "stall-episodes", "series": "heartbeat/stalls",
                     "severity": "critical", "since_unix_s": now - 30}],
         "timeline": []}
    b = {"firing": [{"rule": "stall-episodes", "series": "heartbeat/stalls",
                     "severity": "critical", "since_unix_s": now - 10}],
         "timeline": []}
    c = {"firing": [],
         "timeline": [
             {"event": "fired", "rule": "stall-episodes",
              "severity": "critical", "t_unix_s": now - 100},
             {"event": "fired", "rule": "ancient-rule",
              "severity": "warning", "t_unix_s": now - 9_000}]}
    fleet_export = {"firing": [
        {"rule": "fleet-target-stale",
         "series": "fleet/target/10.0.0.1:8300/stale",
         "severity": "critical", "since_unix_s": now - 5}], "timeline": []}
    incidents = correlate_alerts({"t0": a, "t1": b, "t2": c},
                                 fleet_export, window_s=300, now=now)
    by_rule = {i["rule"]: i for i in incidents}
    stall = by_rule["stall-episodes"]
    assert stall["k"] == 3 and stall["targets"] == ["t0", "t1", "t2"]
    assert stall["firing"] == ["t0", "t1"]         # t2 already resolved
    assert stall["active"] and stall["severity"] == "critical"
    assert stall["first_t_unix_s"] == now - 100
    # the fleet evaluator's own staleness firing names the target from
    # its series spelling
    assert by_rule["fleet-target-stale"]["targets"] == ["10.0.0.1:8300"]
    # outside the window: no incident
    assert "ancient-rule" not in by_rule
    # widest incident ranks first
    assert incidents[0]["rule"] == "stall-episodes"


# --- healthz + serve spool record (satellites) ------------------------------


def test_healthz_is_cheap_and_complete(job_server):
    """GET /healthz: version/uptime/phase/process — none of the /status
    render — and the job counts when a scheduler is attached."""
    obs = job_server
    hz = _get_json(obs.server.url + "/healthz")
    assert hz["schema"] == "moxt-healthz-v1"
    from map_oxidize_tpu_torch import __version__

    assert hz["version"] == __version__
    assert hz["uptime_s"] >= 0
    assert hz["workload"] == "wordcount"
    assert hz["process"] == 0 and hz["n_processes"] == 1
    assert "jobs" not in hz                       # no scheduler attached
    assert "xprof" not in hz and "comms" not in hz  # cheap: no render
    # the index names it
    assert "/healthz" in _get_json(obs.server.url + "/")["endpoints"]


def test_healthz_scheduler_counts(tmp_path, monkeypatch):
    from map_oxidize_tpu_torch.obs.serve import ObsServer

    monkeypatch.setenv("MOXT_OBS_SPOOL", "none")

    class _FakeSched:
        def health_doc(self):
            return {"running": 2, "queued": 3, "queue_depth": 3,
                    "max_queue": 16, "workers": 2, "draining": False}

    cfg = JobConfig(input_path=str(tmp_path / "x")).validate()
    obs = Obs.from_config(cfg)
    srv = ObsServer(obs, cfg, 0, scheduler=_FakeSched())
    srv.start()
    try:
        hz = _get_json(srv.url + "/healthz")
        assert hz["jobs"] == {"running": 2, "queued": 3, "queue_depth": 3,
                              "max_queue": 16, "workers": 2,
                              "draining": False}
    finally:
        srv.stop()
        obs.finish_xprof()


def test_resident_server_publishes_spool_record(tmp_path, monkeypatch):
    """Satellite: the resident server drops <spool>/obs_port.json at
    start (fleet --spool discovery) and removes it on clean shutdown."""
    import threading as _threading

    from map_oxidize_tpu_torch.config import ServeConfig
    from map_oxidize_tpu_torch.serve.server import ResidentServer

    monkeypatch.setenv("MOXT_OBS_SPOOL", "none")
    spool = tmp_path / "spool"
    cfg = ServeConfig(port=0, spool_dir=str(spool),
                      drain_timeout_s=5.0).validate()

    def _runner(config, workload, on_obs):  # pragma: no cover - unused
        raise AssertionError("no jobs submitted")

    srv = ResidentServer(cfg, runner=_runner).start()
    try:
        rec = json.loads((spool / "obs_port.json").read_text())
        assert rec["schema"] == "moxt-obs-port-v1"
        assert rec["kind"] == "serve"
        assert rec["url"] == srv.url and rec["pid"] == os.getpid()
        # fleet --spool discovery resolves it
        found = discover_targets(_fleet_cfg(spool_dirs=[str(spool)]))
        assert list(found.values())[0]["url"] == srv.url
        # the collector sees the serve-plane healthz counts
        clock = _Clock()
        col = FleetCollector(_fleet_cfg(spool_dirs=[str(spool)]),
                             clock=clock)
        doc = col.poll_once(now=clock.t)
        (row,) = doc["targets"]
        assert row["kind"] == "serve" and row["state"] == "up"
        assert row["jobs_running"] == 0
    finally:
        srv.shutdown(drain=True)
    assert not (spool / "obs_port.json").exists()
    # and the departed target resolves, never going stale
    clock.t += 120
    doc = col.poll_once(now=clock.t)
    assert doc["targets"][0]["state"] == "departed"
    assert col.alerts.fired_total == 0


# --- renderers + CLI --------------------------------------------------------


def test_obs_top_renders_fleet_live_and_archive(job_server, tmp_path,
                                                capsys):
    from map_oxidize_tpu_torch.cli import main

    obs = job_server
    clock = _Clock()
    col = FleetCollector(
        _fleet_cfg(targets=[obs.server.url],
                   archive_dir=str(tmp_path / "arch")), clock=clock)
    col.poll_once(now=clock.t)
    srv = FleetServer(col, 0).start()
    try:
        rc = main(["obs", "top", "--url", srv.url, "--iterations", "1",
                   "--no-clear"])
    finally:
        srv.stop()
    out = capsys.readouterr().out
    assert rc == 0
    assert "moxt obs fleet — 1 targets (1 up" in out
    assert "fleet alerts: 0 active incidents" in out
    label = col.status_doc(clock.t)["targets"][0]["target"]
    assert label in out
    # post-mortem: the archived frame renders after the collector dies
    col.stop()
    rc = main(["obs", "top", "--archive", str(tmp_path / "arch")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "moxt obs fleet — 1 targets" in out
    assert "(archived frame as of" in out


def test_obs_where_reads_archive(job_server, tmp_path, capsys):
    """Post-mortem attribution: the archived per-target /status
    snapshots carry each target's last live attribution, renderable
    after every producer process exited."""
    from map_oxidize_tpu_torch.cli import main

    obs = job_server
    clock = _Clock()
    col = FleetCollector(
        _fleet_cfg(targets=[obs.server.url],
                   archive_dir=str(tmp_path / "arch")), clock=clock)
    col.poll_once(now=clock.t)
    label = col.status_doc(clock.t)["targets"][0]["target"]
    col.stop()
    obs.stop_live()                      # every producer gone
    rc = main(["obs", "where", "--archive", str(tmp_path / "arch")])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"where did the time go — {label} (wordcount, archived)" in out
    assert "unattributed" in out
    # --target filters; an unknown label errors cleanly
    assert main(["obs", "where", "--archive", str(tmp_path / "arch"),
                 "--target", label]) == 0
    capsys.readouterr()
    assert main(["obs", "where", "--archive", str(tmp_path / "arch"),
                 "--target", "nope:1"]) == 2


def test_obs_trend_reads_archive(job_server, tmp_path, capsys):
    from map_oxidize_tpu_torch.cli import main

    obs = job_server
    clock = _Clock()
    col = FleetCollector(
        _fleet_cfg(targets=[obs.server.url],
                   archive_dir=str(tmp_path / "arch")), clock=clock)
    for _ in range(4):
        col.poll_once(now=clock.t)
        clock.t += 1
    col.stop()
    rc = main(["obs", "trend", "--archive", str(tmp_path / "arch")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "trend: fleet-archive — 4 entries" in out
    # --last bounds the sample window
    assert main(["obs", "trend", "--archive", str(tmp_path / "arch"),
                 "--last", "2", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["n_entries"] == 2


def test_fleet_cli_end_to_end(job_server, capsys):
    """The obs fleet subcommand itself: bounded iterations against a
    real endpoint, clean exit."""
    from map_oxidize_tpu_torch.cli import main

    obs = job_server
    rc = main(["obs", "fleet", "--targets", obs.server.url,
               "--discover-dir", "none", "--interval", "0.05",
               "--iterations", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[fleet] collector on http://127.0.0.1:" in out


# --- across the packages ------------------------------------------------------


def _jax_job_server(tmp_path):
    from map_oxidize_tpu.config import JobConfig as JaxJobConfig
    from map_oxidize_tpu.obs import Obs as JaxObs

    cfg = JaxJobConfig(input_path=str(tmp_path / "x"), obs_port=0,
                       obs_sample_s=0.05, num_shards=1).validate()
    obs = JaxObs.from_config(cfg)
    obs.workload = "wordcount"
    return obs


def _collector(pkg, cfg_kw, clock):
    if pkg == "port":
        return FleetCollector(_fleet_cfg(**cfg_kw), clock=clock)
    from map_oxidize_tpu.config import FleetConfig as JaxFleetConfig
    from map_oxidize_tpu.obs.fleet import FleetCollector as JaxCollector

    cfg_kw = dict(cfg_kw, discover_dir="none", poll_interval_s=0.5,
                  stale_after_s=5.0)
    return JaxCollector(JaxFleetConfig(**cfg_kw).validate(), clock=clock)


#: the per-target row fields that depend on neither package
_ROW_KEYS = ("target", "url", "source", "kind", "state", "up", "stale",
             "departed", "staleness_s", "last_ok_unix_s", "workload",
             "phase", "rows_per_sec", "hbm_bytes", "hbm_frac", "queue_depth",
             "jobs_running", "alerts_firing", "scrape_errors",
             "scrape_refused")


@pytest.mark.parametrize("collector", ["port", "jax"])
def test_a_collector_merges_both_packages_obs_servers(job_server, tmp_path,
                                                      collector):
    """A port collector over a JAX ``ObsServer`` and a JAX collector over a
    port one (each beside a server of its own package): both accept every
    payload, and both give the same fleet ``/status`` target set, labels
    and rows."""
    theirs = _jax_job_server(tmp_path)
    try:
        for obs in (job_server, theirs):
            obs.registry.set("hbm/live_bytes_device0", 3 << 20)
            obs.registry.set("hbm/budget_bytes", 1 << 24)
        urls = [job_server.server.url, theirs.server.url]
        docs = {}
        for pkg in ("port", "jax"):
            clock = _Clock()
            docs[pkg] = _collector(pkg, {"targets": urls}, clock).poll_once(
                now=clock.t)
        doc = docs[collector]
        labels = sorted(u[len("http://"):] for u in urls)
        assert [r["target"] for r in doc["targets"]] == labels
        assert doc["counts"] == {"targets": 2, "up": 2, "stale": 0,
                                 "departed": 0}
        assert all(r["kind"] == "job" and r["hbm_frac"] == 0.1875
                   and r["scrape_refused"] == 0 for r in doc["targets"])
        rows = {pkg: [{k: r.get(k) for k in _ROW_KEYS}
                      for r in d["targets"]] for pkg, d in docs.items()}
        assert rows["port"] == rows["jax"]
        assert docs["port"]["aggregates"] == docs["jax"]["aggregates"]
    finally:
        theirs.stop_live()
        theirs.finish_xprof()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_archive_reads_alike_in_both_packages(job_server, tmp_path,
                                                 writer):
    """A port-written archive read by the JAX ``obs trend/top/where
    --archive``, and the reverse: the same stdout bytes and exit codes
    from both CLIs."""
    import contextlib
    import io

    from map_oxidize_tpu.cli import main as jax_main
    from map_oxidize_tpu_torch.cli import main as port_main

    obs = job_server
    arch = str(tmp_path / "arch")
    clock = _Clock()
    col = _collector(writer, {"targets": [obs.server.url],
                              "archive_dir": arch}, clock)
    for _ in range(4):
        col.poll_once(now=clock.t)
        clock.t += 1
    col.stop()
    label = obs.server.url[len("http://"):]

    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main(["obs", *argv, "--archive", arch])
        return rc, out.getvalue()

    for argv in (["trend"], ["trend", "--json", "--last", "3"], ["top"],
                 ["where"], ["where", "--target", label], ["critpath"]):
        got, ref = run(port_main, argv), run(jax_main, argv)
        assert got == ref and got[0] == 0, argv
    assert "trend: fleet-archive — 4 entries" in run(port_main, ["trend"])[1]
    assert label in run(port_main, ["top"])[1]
