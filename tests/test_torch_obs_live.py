"""The port's live telemetry plane (``obs/serve.py``, ``obs/timeseries.py``,
the live hooks of ``Obs.from_config``) against the JAX package's, on the
CPU: the JAX suite ``tests/test_obs_live.py`` less its comms and
multi-process cases (the sharded and multi-process paths are not ported
yet).  A slowed word count holds a real job open so mid-run scrapes are
deterministic; the status and Prometheus documents are held to the JAX
package's over the same registry.
"""

import dataclasses
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from map_oxidize_tpu import obs as jax_obs_pkg
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import serve as jax_serve
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs import serve as port_serve


def _get(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _get_json(url: str) -> dict:
    return json.loads(_get(url))


def _write_corpus(path, lines: int = 400) -> int:
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    rng = np.random.default_rng(7)
    with open(path, "wb") as f:
        for _ in range(lines):
            f.write(b" ".join(words[int(i)]
                              for i in rng.integers(0, 6, 8)) + b"\n")
    return os.path.getsize(path)


class _SlowMapper:
    """Delegating mapper that sleeps per chunk: holds a real job open so
    mid-run scrapes are deterministic, output identical to the inner
    mapper's."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay = delay_s

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def map_chunk(self, chunk):
        time.sleep(self._delay)
        return self._inner.map_chunk(chunk)


# --- one job: endpoints during a real job -----------------------------------


@pytest.fixture(scope="module")
def live_job(tmp_path_factory):
    """One slowed word count of the port with the live plane on: /status,
    /metrics and /series scraped MID-run, plus the job's result and final
    metrics document."""
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    tmp = tmp_path_factory.mktemp("live")
    corpus = tmp / "c.txt"
    _write_corpus(corpus)
    mapper, reducer = make_wordcount("ascii", use_native=False)
    cfg = JobConfig(
        input_path=str(corpus), output_path="", metrics=False,
        backend="cpu", num_chunks=10, batch_size=1 << 12,
        key_capacity=1 << 12, num_map_workers=1, mapper="python",
        obs_port=0, obs_sample_s=0.02, trace_out="-",
        metrics_out=str(tmp / "metrics.json"))
    portfile = tmp / "ports.txt"
    os.environ["MOXT_OBS_PORT_FILE"] = str(portfile)
    box: dict = {}

    def _run():
        try:
            box["result"] = run_wordcount_job(
                cfg, _SlowMapper(mapper, 0.15), reducer)
        except BaseException as e:  # pragma: no cover - surfaced below
            box["error"] = e

    t = threading.Thread(target=_run)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while not portfile.exists() and time.monotonic() < deadline:
            time.sleep(0.005)
        port = int(portfile.read_text().split()[1])
        url = f"http://127.0.0.1:{port}"
        status = None
        while time.monotonic() < deadline:
            status = _get_json(url + "/status")
            if status.get("phase") == "map+reduce":
                break
            time.sleep(0.01)
        scrapes = {
            "status": status,
            "metrics": _get(url + "/metrics").decode(),
            "series": _get_json(url + "/series"),
            "index": _get_json(url + "/"),
            "healthz": _get_json(url + "/healthz"),
            "alerts": _get_json(url + "/alerts"),
        }
        time.sleep(0.4)
        scrapes["status2"] = _get_json(url + "/status")
    finally:
        t.join(timeout=120)
        os.environ.pop("MOXT_OBS_PORT_FILE", None)
    if "error" in box:
        raise box["error"]
    assert not t.is_alive()
    return cfg, box["result"], scrapes, url, tmp


def test_status_schema_mid_run(live_job):
    _cfg, _result, scrapes, _url, _tmp = live_job
    s = scrapes["status"]
    assert s["schema"] == "moxt-status-v1"
    assert s["phase"] == "map+reduce"
    assert s["meta"]["workload"] == "wordcount"
    assert s["meta"]["version"] and s["meta"]["config_hash"]
    assert s["elapsed_s"] > 0
    assert s["comms"] == []          # no sharded engine: present, empty
    assert "open_spans" in s and "xprof" in s and "attrib" in s
    assert s["progress"]["rows"] >= 0 and "fraction" in s["progress"]
    assert scrapes["healthz"]["schema"] == "moxt-healthz-v1"
    assert scrapes["alerts"]["schema"] == "moxt-alerts-v1"
    assert scrapes["index"]["endpoints"] == [
        "/healthz", "/metrics", "/status", "/series", "/alerts",
        "POST /profile"]


def test_status_updates_mid_run(live_job):
    _cfg, result, scrapes, _url, _tmp = live_job
    s1, s2 = scrapes["status"], scrapes["status2"]
    assert s2["t_unix_s"] > s1["t_unix_s"]
    assert s2["progress"]["rows"] >= s1["progress"]["rows"] >= 0
    assert 0 < s2["progress"]["rows"] <= sum(result.counts.values())


def test_prometheus_text_mid_run(live_job):
    _cfg, _result, scrapes, _url, _tmp = live_job
    text = scrapes["metrics"]
    assert "# TYPE" in text
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{")[0].split(" ")[0]
        assert name.startswith("moxt_")
        assert all(c.isalnum() or c in "_:" for c in name), name
        float(line.rsplit(" ", 1)[1])


def test_series_schema_and_final_doc(live_job):
    _cfg, _result, scrapes, _url, tmp = live_job
    live = scrapes["series"]
    assert live["schema"] == "moxt-series-v1"
    assert live["interval_s"] == pytest.approx(0.02)
    doc = json.loads((tmp / "metrics.json").read_text())
    series = doc["series"]
    t = series["t_unix_s"]
    assert len(t) >= 2 and t == sorted(t)
    assert series["samples_taken"] >= len(t)
    for name, vals in series["series"].items():
        assert len(vals) == len(t), name
    assert any(k.startswith("feed_block_ms") for k in series["series"])
    assert "progress/rows" in series["series"]
    assert "compile/total_compiles" in series["series"]
    assert doc["alerts"]["schema"] == "moxt-alerts-v1"
    assert doc["meta"]["version"]


def test_server_down_after_finish(live_job):
    _cfg, _result, _scrapes, url, _tmp = live_job
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(url + "/status", timeout=2)


def test_zero_compile_delta_from_live_plane(live_job):
    """The telemetry plane changes nothing that runs: the dark run of the
    same job observes the same programs and counts the same words."""
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    cfg, result, _scrapes, _url, _tmp = live_job
    mapper, reducer = make_wordcount("ascii", use_native=False)
    dark = dataclasses.replace(cfg, obs_port=-1, obs_sample_s=0.0,
                               trace_out=None, metrics_out=None)
    r2 = run_wordcount_job(dark, mapper, reducer)

    def programs(m):
        return {k for k in m if k.startswith("xprof/")
                and k.endswith("/dispatches")}

    assert programs(result.metrics) == programs(r2.metrics)
    assert r2.metrics["compile/total_compiles"] == 0
    assert dict(r2.counts) == dict(result.counts)


# --- the documents against the JAX package's --------------------------------


def _twin_bundles(tmp_path):
    """A port bundle and a JAX bundle (live series, no server), with the
    same registry operations applied to both."""
    out = []
    for pkg, cfg_cls in ((Obs, JobConfig), (jax_obs_pkg.Obs, JaxJobConfig)):
        cfg = cfg_cls(input_path=str(tmp_path / "x"), obs_sample_s=30.0)
        obs = pkg.from_config(cfg)
        reg = obs.registry
        reg.count("rows_fed", 7)
        reg.set("shuffle/transport", "hybrid")
        reg.count("spill/rows", 3)
        reg.set("hbm/live_bytes_device0", 123)
        reg.set("critpath/bound_frac", 0.5)
        reg.set("calib/store_runs", 0)
        reg.set("data/imbalance_factor", 1.5)
        for v in (1.0, 2.0, 5.0):
            reg.observe("feed_block_ms", v)
        reg.observe("serve/queue_wait_ms", 12.0, buckets=(5.0, 50.0))
        obs.heartbeat.set_phase("map+reduce")
        obs.heartbeat.update(rows=10)
        out.append((obs, cfg))
    return out


def test_status_and_prometheus_key_sets_match_jax_over_one_registry(
        tmp_path):
    (mine, mcfg), (ref, rcfg) = _twin_bundles(tmp_path)
    try:
        a = port_serve.build_status(mine, mcfg, "wordcount")
        b = jax_serve.build_status(ref, rcfg, "wordcount")
        assert set(a) == set(b)
        for key in ("meta", "progress", "hbm", "counters", "shuffle",
                    "critpath", "calib", "data", "attrib"):
            assert set(a[key]) == set(b[key]), key
        assert a["shuffle"] == b["shuffle"] and a["comms"] == b["comms"]
        assert port_serve.prometheus_text(mine.registry) == \
            jax_serve.prometheus_text(ref.registry)
        # the /healthz document over each bundle
        srvs = [types.SimpleNamespace(obs=o, scheduler=None)
                for o in (mine, ref)]
        ha, hb = (m.build_healthz(s) for m, s in zip(
            (port_serve, jax_serve), srvs))
        assert set(ha) == set(hb) and ha["phase"] == hb["phase"]
        assert port_serve.sanitize_metric_name("a/b+c") == \
            jax_serve.sanitize_metric_name("a/b+c")
        assert port_serve.PORT_RECORD_SCHEMA == jax_serve.PORT_RECORD_SCHEMA
        for p in (0, 5):
            assert port_serve.serve_port_for_process(p, 1) == \
                jax_serve.serve_port_for_process(p, 1)
    finally:
        for obs, cfg in ((mine, mcfg), (ref, rcfg)):
            obs.stop_live()
            obs.finish_xprof()


# --- concurrent scrape safety ----------------------------------------------


def test_concurrent_scrape_safety(tmp_path):
    """Hammer the endpoints from threads while counters and histograms
    churn: every response parses, none 500s, the server survives."""
    cfg = JobConfig(input_path=str(tmp_path / "x"), obs_port=0,
                    obs_sample_s=0.01).validate()
    obs = Obs.from_config(cfg)
    stop = threading.Event()

    def _churn():
        i = 0
        while not stop.is_set():
            obs.registry.count("churn/counter", 1)
            obs.registry.observe("churn/hist_ms", i % 17)
            i += 1

    churner = threading.Thread(target=_churn, daemon=True)
    churner.start()
    errors: list = []
    url = obs.server.url

    def _scrape(ep):
        try:
            for _ in range(30):
                body = _get(url + ep)
                if ep != "/metrics":
                    assert "error" not in json.loads(body)
        except Exception as e:
            errors.append((ep, e))

    threads = [threading.Thread(target=_scrape, args=(ep,))
               for ep in ("/metrics", "/status", "/series", "/alerts")
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    churner.join(timeout=10)
    obs.stop_live()
    obs.finish_xprof()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


# --- ring-buffer bounds ----------------------------------------------------


def test_ring_buffer_bounds_like_jax():
    from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from map_oxidize_tpu.obs.timeseries import (
        TimeSeriesRecorder as JaxRecorder,
    )
    from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
    from map_oxidize_tpu_torch.obs.timeseries import TimeSeriesRecorder

    outs = []
    for reg_cls, rec_cls in ((MetricsRegistry, TimeSeriesRecorder),
                             (JaxRegistry, JaxRecorder)):
        reg = reg_cls()
        ticks = iter(range(1000))
        tsr = rec_cls(reg, interval_s=1.0, capacity=8,
                      clock=lambda t=ticks: float(next(t)))
        for _ in range(20):
            reg.count("c", 1)
            reg.observe("h_ms", 2.0)
            tsr.sample_once()
        outs.append(tsr.export())
    out = outs[0]
    assert out == outs[1]
    assert out["samples_taken"] == 20 and len(out["t_unix_s"]) == 8
    assert out["t_unix_s"] == [float(i) for i in range(12, 20)]
    assert out["series"]["c"] == [float(i) for i in range(13, 21)]


# --- flight-recorder path --------------------------------------------------


def test_live_plane_shutdown_on_abort(tmp_path):
    """An aborting job stops the series thread AND the server (the flight
    path), and the crash bundle carries the series ring."""
    cfg = JobConfig(input_path=str(tmp_path / "x"), obs_port=0,
                    obs_sample_s=0.01,
                    crash_dir=str(tmp_path / "crash")).validate()
    obs = Obs.from_config(cfg)
    url = obs.server.url
    assert _get_json(url + "/status")["schema"] == "moxt-status-v1"
    with pytest.raises(RuntimeError, match="boom"):
        with obs.recording(cfg, "wordcount"):
            obs.registry.count("did_work", 3)
            raise RuntimeError("boom")
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(url + "/status", timeout=2)
    obs.series._thread.join(timeout=10)
    assert not obs.series._thread.is_alive()
    (bundle,) = list((tmp_path / "crash").iterdir())
    doc = json.loads((bundle / "metrics.json").read_text())
    assert doc["series"]["schema"] == "moxt-series-v1"
    assert doc["alerts"]["schema"] == "moxt-alerts-v1"
    assert doc["counters"]["did_work"] == 3
    # the JAX obs CLI reads the port's bundle directly
    from map_oxidize_tpu.cli import main as jax_main

    assert jax_main(["obs", "xprof", str(bundle)]) == 0


def test_jax_obs_diff_reads_the_port_ledger_and_crash_dir(tmp_path,
                                                          capsys):
    """``obs diff --crash-dir`` of the JAX CLI compares the port's flight
    bundle against the port's ledger with no extraction."""
    from map_oxidize_tpu.cli import main as jax_main
    from map_oxidize_tpu_torch.obs import ledger

    cfg = JobConfig(input_path=str(tmp_path / "x"),
                    ledger_dir=str(tmp_path / "ledger"),
                    crash_dir=str(tmp_path / "crash")).validate()
    obs = Obs.from_config(cfg)
    with obs.recording(cfg, "wordcount"):
        obs.registry.count("comms/psum/p/bytes", 1024)
    obs.finish(cfg, "wordcount")
    obs2 = Obs.from_config(cfg)
    with pytest.raises(RuntimeError):
        with obs2.recording(cfg, "wordcount"):
            obs2.registry.count("comms/psum/p/bytes", 4096)
            raise RuntimeError("injected")
    assert len(ledger.read(str(tmp_path / "ledger"))) == 1
    rc = jax_main(["obs", "diff", "--ledger-dir", str(tmp_path / "ledger"),
                   "--crash-dir", str(tmp_path / "crash"), "--gate"])
    out = capsys.readouterr().out
    assert "crash bundle" in out and "comms/psum/p/bytes" in out
    assert rc == 3


# --- obs context isolation -------------------------------------------------


def test_two_obs_context_isolation(tmp_path):
    """Two concurrent jobs in one process keep disjoint metrics: launches
    of an observed program under each context land in that job's
    registry and launch-ledger overlay only."""
    from map_oxidize_tpu_torch.obs.compile import job_overlay_delta, observed
    from map_oxidize_tpu_torch.obs.context import current_obs, use_obs

    cfg = JobConfig(input_path=str(tmp_path / "x")).validate()
    obs_a = Obs.from_config(cfg)
    obs_b = Obs.from_config(cfg)
    prog = observed("ctx/test_prog", lambda x: x + 1)
    barrier = threading.Barrier(2)

    def _job(obs, n, arr):
        with use_obs(obs):
            assert current_obs() is obs
            barrier.wait(timeout=30)
            for _ in range(n):
                prog(arr)

    x = torch.arange(8)
    ta = threading.Thread(target=_job, args=(obs_a, 5, x))
    tb = threading.Thread(target=_job, args=(obs_b, 9, x))
    ta.start()
    tb.start()
    ta.join(timeout=120)
    tb.join(timeout=120)
    assert not ta.is_alive() and not tb.is_alive()
    live = (job_overlay_delta(obs_a)["ctx/test_prog"]["dispatches"],
            job_overlay_delta(obs_b)["ctx/test_prog"]["dispatches"])
    assert live == (5, 9)
    da = obs_a.finish_xprof()
    db = obs_b.finish_xprof()
    assert (da["programs"]["ctx/test_prog"]["dispatches"],
            db["programs"]["ctx/test_prog"]["dispatches"]) == (5, 9)
    assert job_overlay_delta(obs_a) == {}    # the window closed
    ha = obs_a.registry.histograms.get("device/dispatch_gap_ms")
    hb = obs_b.registry.histograms.get("device/dispatch_gap_ms")
    assert ha.count + hb.count == 5 + 9 - 1  # one call compiled


def test_obs_context_reaches_prefetch_threads(tmp_path):
    """Launches made while mapping IN THE PREFETCH THREAD route to the
    spawning job: two concurrent jobs each count exactly their own
    chunks of an observed program."""
    from map_oxidize_tpu_torch.obs.compile import observed
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    prog = observed("ctx/prefetch_prog", lambda x: x * 2)
    barrier = threading.Barrier(2)

    class _DispatchingMapper:
        def __init__(self, inner):
            self._inner = inner
            self._first = True

        def __getattr__(self, item):
            return getattr(self._inner, item)

        def map_chunk(self, chunk):
            if self._first:
                self._first = False
                barrier.wait(timeout=60)
            prog(torch.arange(8))
            return self._inner.map_chunk(chunk)

    chunks = {"a": 6, "b": 10}
    results: dict = {}

    def _job(name):
        corpus = tmp_path / f"{name}.txt"
        _write_corpus(corpus, lines=40)
        mapper, reducer = make_wordcount("ascii", use_native=False)
        cfg = JobConfig(
            input_path=str(corpus), output_path="", metrics=False,
            backend="cpu", num_chunks=chunks[name], num_map_workers=1,
            pipeline_depth=3, batch_size=1 << 12, key_capacity=1 << 12,
            mapper="python")
        try:
            results[name] = run_wordcount_job(
                cfg, _DispatchingMapper(mapper), reducer)
        except BaseException as e:  # pragma: no cover - surfaced below
            results[name] = e

    threads = [threading.Thread(target=_job, args=(n,)) for n in chunks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    for name, r in results.items():
        assert not isinstance(r, BaseException), (name, r)
    na = results["a"].metrics.get("xprof/ctx/prefetch_prog/dispatches", 0)
    nb = results["b"].metrics.get("xprof/ctx/prefetch_prog/dispatches", 0)
    assert (na, nb) == (chunks["a"], chunks["b"])
