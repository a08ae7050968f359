"""The port's resident job service (``serve/``) against the JAX package's,
on the CPU: the JAX suite ``tests/test_serve.py`` case by case — the
admission decisions and estimates (equal to JAX's on the same configs and
budgets), cancel/deadline through the flight recorder, the bounded queue,
the graceful drain, warm jobs with zero compiles, concurrent jobs with
disjoint per-job state, the ``/jobs`` HTTP plane — plus a server of each
package serving the same jobs, held to identical outputs.

Scheduler-level tests inject HELD runners (an event gates the job body)
so admission and cancellation windows are deterministic; the server tests
drive real jobs through the real drivers with ``backend='cpu'``.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.config import ServeConfig as JaxServeConfig
from map_oxidize_tpu.serve import admission as jax_admission
from map_oxidize_tpu_torch.config import (
    SERVE_WORKLOADS,
    WORKLOADS,
    JobConfig,
    ServeConfig,
)
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.serve import admission
from map_oxidize_tpu_torch.serve.admission import AdmissionController
from map_oxidize_tpu_torch.serve.corpus import CorpusCache
from map_oxidize_tpu_torch.serve.scheduler import (
    RESERVED_OVERRIDES,
    Scheduler,
)

#: JobConfig fields of the JAX package the port has not got: none (the
#: multi-process fields came with the multi-process drivers)
JAX_ONLY_FIELDS: set = set()


def _write_corpus(path, lines=200, words=None):
    words = words or [b"alpha", b"beta", b"gamma", b"delta"]
    rng = np.random.default_rng(11)
    with open(path, "wb") as f:
        for _ in range(lines):
            f.write(b" ".join(words[int(i)]
                              for i in rng.integers(0, len(words), 8))
                    + b"\n")
    return str(path)


def _serve_cfg(tmp_path, **kw) -> ServeConfig:
    kw.setdefault("port", 0)
    kw.setdefault("spool_dir", str(tmp_path / "spool"))
    kw.setdefault("job_sample_s", 0.05)
    kw.setdefault("drain_timeout_s", 5.0)
    return ServeConfig(**kw).validate()


def _held_runner(release: threading.Event):
    """A runner whose job body blocks on ``release`` inside a real
    ``Obs.recording`` envelope, polling the cancellation point."""

    def run(config, workload, on_obs):
        obs = Obs.from_config(config)
        on_obs(obs)
        with obs.recording(config, workload):
            obs.registry.count("held/progress", 1)
            while not release.wait(0.01):
                obs.poll_cancel()
        obs.finish(config, workload)

        class _R:
            metrics = {"records_in": 1}

        return _R()

    return run


def _until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


# --- config + admission units ----------------------------------------------


def test_config_fields_are_the_jax_package_s_less_the_sharded_ones():
    mine = {f.name: f.default for f in dataclasses.fields(JobConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxJobConfig)}
    assert set(ref) - set(mine) == JAX_ONLY_FIELDS
    assert set(mine) <= set(ref)
    assert {k for k in mine if mine[k] != ref[k]} == {"backend"}
    serve = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert serve == {f.name: f.default
                     for f in dataclasses.fields(JaxServeConfig)}
    assert SERVE_WORKLOADS == WORKLOADS


def test_serve_config_validates():
    for kw in ({"workers": 0}, {"max_queue": 0}, {"port": 70000},
               {"hbm_budget_bytes": -1}, {"max_history": 0},
               {"spool_dir": ""}, {"slo_rules": "[1]"}):
        with pytest.raises(ValueError):
            ServeConfig(**kw).validate()
        with pytest.raises(ValueError):
            JaxServeConfig(**kw).validate()
    assert ServeConfig().validate().workers >= 1


@pytest.mark.parametrize("ctl", [AdmissionController,
                                 jax_admission.AdmissionController],
                         ids=["port", "jax"])
def test_admission_decisions(ctl):
    adm = ctl(budget_bytes=1000)
    assert adm.decide(400) == ("admit", "")
    decision, reason = adm.decide(2000)
    assert decision == "reject"
    assert "working_set_exceeds_hbm_budget" in reason
    adm.reserve(700)
    decision, reason = adm.decide(400)
    assert decision == "defer" and "hbm_budget_busy" in reason
    adm.release(700)
    assert adm.decide(400)[0] == "admit"
    assert ctl(0).decide(1 << 50)[0] == "admit"


def _estimate_cases(tmp_path):
    pts = tmp_path / "pts.npy"
    np.save(pts, np.zeros((5000, 24), np.float32))
    big = tmp_path / "big.npy"
    # a header for 2^26 rows of 64 floats, no data: only the header is read
    with open(big, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<f4", "fortran_order": False, "shape": (1 << 26, 64)})
    corpus = _write_corpus(tmp_path / "c.txt")
    return [
        ("wordcount", {"input_path": corpus}),
        ("wordcount", {"input_path": corpus, "key_capacity": 1 << 33}),
        ("bigram", {"input_path": corpus, "batch_size": 1 << 12}),
        ("distinct", {"input_path": corpus, "hll_precision": 16}),
        ("invertedindex", {"input_path": corpus}),
        ("sort", {"input_path": corpus, "batch_size": 1 << 20}),
        ("join", {"input_path": corpus}),
        ("sessionize", {"input_path": corpus}),
        ("kmeans", {"input_path": str(pts), "kmeans_k": 16}),
        ("kmeans", {"input_path": str(big), "kmeans_k": 512}),
        ("kmeans", {"input_path": str(pts), "kmeans_k": 64,
                    "kmeans_device_fit_bytes": 1 << 10}),
        ("kmeans", {"input_path": str(tmp_path / "corrupt.npy")}),
    ]


def test_estimates_and_decisions_equal_jax(tmp_path):
    """``estimate_hbm_bytes`` and ``AdmissionController.decide`` give the
    JAX package's answers for the same configs and budgets."""
    (tmp_path / "corrupt.npy").write_bytes(b"not a header" * 100)
    budgets = (0, 1 << 20, 1 << 30, 80 << 30)
    for workload, kw in _estimate_cases(tmp_path):
        mine = admission.estimate_hbm_bytes(
            JobConfig(backend="cpu", **kw), workload)
        ref = jax_admission.estimate_hbm_bytes(
            JaxJobConfig(backend="cpu", num_shards=1, **kw), workload)
        assert mine == ref, (workload, kw)
        for budget in budgets:
            for reserved in (0, budget // 2):
                a = AdmissionController(budget)
                b = jax_admission.AdmissionController(budget)
                a.reserve(reserved)
                b.reserve(reserved)
                assert a.decide(mine) == b.decide(ref), (workload, budget)
    # no CUDA initialised here: the probe reads 0 and admission stays open
    assert admission.probe_hbm_budget() == 0
    assert admission.measured_live_bytes() == 0


def test_corpus_cache_idle_eviction(tmp_path):
    clock = [0.0]
    cache = CorpusCache(idle_evict_s=10.0, clock=lambda: clock[0])
    path = _write_corpus(tmp_path / "c.txt", lines=5)
    assert cache.open(path) == os.path.getsize(path) and path in cache
    with pytest.raises(OSError):
        cache.open(str(tmp_path / "missing.txt"))
    clock[0] = 9.0
    assert cache.evict_idle() == 0 and len(cache) == 1
    cache.touch(path)
    clock[0] = 18.0
    assert cache.evict_idle() == 0
    clock[0] = 30.0
    assert cache.evict_idle() == 1 and len(cache) == 0
    assert cache.evictions == 1


# --- scheduler: admission, queue bound, cancel/deadline, drain --------------


def test_oversized_job_rejected_named(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    sched = Scheduler(_serve_cfg(tmp_path, hbm_budget_bytes=1 << 20),
                      runner=_held_runner(threading.Event()))
    sched.start()
    try:
        job = sched.submit("wordcount", corpus, est_hbm_bytes=2 << 20)
        assert job.state == "rejected"
        assert "working_set_exceeds_hbm_budget" in job.reason
        assert not os.path.isdir(os.path.join(sched.cfg.spool_dir, job.id))
        # the estimate alone: a key capacity past the budget
        big = sched.submit("wordcount", corpus,
                           overrides={"key_capacity": 1 << 20})
        assert big.state == "rejected"
        assert big.reason.startswith("working_set_exceeds_hbm_budget")
    finally:
        sched.shutdown()


def test_deferred_job_runs_after_hbm_frees(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path, hbm_budget_bytes=1000,
                                 workers=2), runner=_held_runner(release))
    sched.start()
    try:
        a = sched.submit("wordcount", corpus, est_hbm_bytes=700)
        _until(lambda: a.state == "running")
        b = sched.submit("wordcount", corpus, est_hbm_bytes=600)
        _until(lambda: b.defer_reason is not None)
        assert b.state == "queued"
        assert "hbm_budget_busy" in b.defer_reason
        assert sched.job_doc(b.id)["reason"] == b.defer_reason
        release.set()
        assert sched.wait(a.id, timeout=30).state == "done"
        assert sched.wait(b.id, timeout=30).state == "done"
    finally:
        release.set()
        sched.shutdown()


def test_queue_bound_rejects_named(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path, workers=1, max_queue=1),
                      runner=_held_runner(release))
    sched.start()
    try:
        a = sched.submit("wordcount", corpus)
        _until(lambda: a.state == "running")
        b = sched.submit("wordcount", corpus)
        c = sched.submit("wordcount", corpus)
        assert b.state == "queued"
        assert c.state == "rejected" and "queue_full" in c.reason
        release.set()
        assert sched.wait(b.id, timeout=30).state == "done"
    finally:
        release.set()
        sched.shutdown()


def test_submit_validation_errors(tmp_path):
    """Malformed submissions raise named errors; an unknown field fails at
    submit as unknown, the multi-process fields as reserved (the JAX
    list, unchanged), and the remote-stage fields are known overrides, as
    in the JAX package (``serve/scheduler.py:66-71``)."""
    from map_oxidize_tpu.serve.scheduler import (
        RESERVED_OVERRIDES as JAX_RESERVED,
    )

    assert RESERVED_OVERRIDES == JAX_RESERVED
    sched = Scheduler(_serve_cfg(tmp_path),
                      runner=_held_runner(threading.Event()))
    corpus = _write_corpus(tmp_path / "c.txt")
    try:
        with pytest.raises(ValueError, match="unknown workload"):
            sched.submit("terasort", corpus)
        for name in ("metrics_out", "dist_coordinator", "obs_port",
                     "dist_num_processes", "dist_process_id"):
            with pytest.raises(ValueError, match="reserved"):
                sched.submit("wordcount", corpus, overrides={name: "x"})
        with pytest.raises(ValueError, match="unknown config"):
            sched.submit("wordcount", corpus, overrides={"nope": "x"})
        # the remote-stage fields are known overrides, validated as the
        # JAX package validates them
        with pytest.raises(ValueError, match="remote_stage_timeout_s"):
            sched.submit("wordcount", corpus,
                         overrides={"remote_stage_timeout_s": 0})
        job = sched.submit("wordcount", corpus, overrides={
            "remote_stage_dir": str(tmp_path / "stage"),
            "remote_stage_timeout_s": 5.0})
        assert job.state != "rejected"
        assert job.config.remote_stage_dir == str(tmp_path / "stage")
        assert job.config.remote_stage_timeout_s == 5.0
        with pytest.raises(ValueError):
            sched.submit("wordcount", corpus, overrides={"batch_size": -1})
        missing = sched.submit("wordcount", str(tmp_path / "missing.txt"))
        assert missing.state == "rejected"
        assert "input_not_found" in missing.reason
    finally:
        sched.shutdown()


def test_rejected_history_stays_bounded(tmp_path):
    sched = Scheduler(_serve_cfg(tmp_path, max_history=5),
                      runner=_held_runner(threading.Event()))
    try:
        for _ in range(25):
            job = sched.submit("wordcount", str(tmp_path / "missing.txt"))
            assert job.state == "rejected"
        assert len(sched.job_ids()) <= 6
    finally:
        sched.shutdown()


def test_wait_unknown_job_raises_named_keyerror(tmp_path):
    sched = Scheduler(_serve_cfg(tmp_path),
                      runner=_held_runner(threading.Event()))
    try:
        with pytest.raises(KeyError, match="job-9999"):
            sched.wait("job-9999", timeout=1)
    finally:
        sched.shutdown()


def test_worker_slot_survives_base_exception(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    boom = {"armed": True}
    release = threading.Event()
    release.set()

    def runner(config, workload, on_obs):
        if boom.pop("armed", False):
            raise SystemExit("job body bailed")
        return _held_runner(release)(config, workload, on_obs)

    sched = Scheduler(_serve_cfg(tmp_path, workers=1), runner=runner)
    sched.start()
    try:
        bad = sched.submit("wordcount", corpus)
        assert sched.wait(bad.id, timeout=30).state == "failed"
        assert "SystemExit" in bad.reason
        ok = sched.submit("wordcount", corpus)
        assert sched.wait(ok.id, timeout=30).state == "done"
    finally:
        sched.shutdown()


def test_submit_cli_choices_track_served_workloads():
    from map_oxidize_tpu.serve.cli import build_submit_parser as jax_parser
    from map_oxidize_tpu_torch.serve.cli import (
        build_serve_parser,
        build_submit_parser,
    )

    action = next(a for a in build_submit_parser()._actions
                  if a.dest == "workload")
    assert tuple(action.choices) == SERVE_WORKLOADS
    from map_oxidize_tpu.serve.cli import build_serve_parser as jax_serve

    for mine, ref in ((build_submit_parser(), jax_parser()),
                      (build_serve_parser(), jax_serve())):
        assert {(a.dest, repr(a.default)) for a in mine._actions} == \
            {(a.dest, repr(a.default)) for a in ref._actions}


def test_cancel_running_job_flight_recorded(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path), runner=_held_runner(release))
    sched.start()
    try:
        job = sched.submit("wordcount", corpus)
        _until(lambda: job.state == "running")
        sched.cancel(job.id, reason="cancelled_by_client")
        done = sched.wait(job.id, timeout=30)
        assert done.state == "cancelled"
        assert done.reason == "cancelled_by_client"
        (bundle,) = os.listdir(done.config.crash_dir)
        with open(os.path.join(done.config.crash_dir, bundle,
                               "metrics.json")) as f:
            doc = json.load(f)
        assert doc["counters"]["held/progress"] == 1
        assert doc["gauges"]["aborted"] is True
        assert doc["series"]["schema"] == "moxt-series-v1"
        with open(os.path.join(done.config.crash_dir, bundle,
                               "error.json")) as f:
            assert "JobCancelled" in json.load(f)["error"]
    finally:
        release.set()
        sched.shutdown()


def test_deadline_cancels_running_job(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path), runner=_held_runner(release))
    sched.start()
    try:
        job = sched.submit("wordcount", corpus, deadline_s=0.3)
        done = sched.wait(job.id, timeout=30)
        assert done.state == "cancelled"
        assert done.reason == "deadline_exceeded"
        assert os.listdir(done.config.crash_dir)
    finally:
        release.set()
        sched.shutdown()


def test_cancel_queued_job_immediate(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path, workers=1),
                      runner=_held_runner(release))
    sched.start()
    try:
        a = sched.submit("wordcount", corpus)
        b = sched.submit("wordcount", corpus)
        sched.cancel(b.id)
        assert b.state == "cancelled"
        assert not os.path.isdir(b.config.crash_dir)
        release.set()
        assert sched.wait(a.id, timeout=30).state == "done"
    finally:
        release.set()
        sched.shutdown()


def test_drain_finishes_running_rejects_new(tmp_path):
    corpus = _write_corpus(tmp_path / "c.txt")
    release = threading.Event()
    sched = Scheduler(_serve_cfg(tmp_path, workers=1),
                      runner=_held_runner(release))
    sched.start()
    job = sched.submit("wordcount", corpus)
    _until(lambda: job.state == "running")
    sched.request_shutdown(drain=True)
    late = sched.submit("wordcount", corpus)
    assert late.state == "rejected" and "server_draining" in late.reason
    release.set()
    sched.shutdown()
    assert job.state == "done"
    doc = sched.jobs_doc()
    assert doc["draining"] is True
    assert doc["counts"] == {"done": 1, "rejected": 1}


# --- real jobs through a resident server of each package --------------------


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from map_oxidize_tpu.serve.server import ResidentServer as JaxServer
    from map_oxidize_tpu_torch.serve.server import ResidentServer

    tmp = tmp_path_factory.mktemp("serve")
    out = {}
    for name, srv_cls, cfg_cls in (("port", ResidentServer, ServeConfig),
                                   ("jax", JaxServer, JaxServeConfig)):
        cfg = cfg_cls(port=0, workers=2, spool_dir=str(tmp / f"sp_{name}"),
                      job_sample_s=0.05, drain_timeout_s=10.0).validate()
        out[name] = srv_cls(cfg).start()
    yield out, tmp
    for srv in out.values():
        srv.shutdown()


@pytest.fixture(scope="module")
def clients(servers):
    from map_oxidize_tpu_torch.serve.client import ServeClient

    srvs, _tmp = servers
    return {n: ServeClient(s.url) for n, s in srvs.items()}


#: per-package job overrides: the Python map on one device, no native dep
OVERRIDES = {
    "port": {"num_chunks": 6, "batch_size": 1 << 12, "key_capacity": 1 << 12,
             "num_map_workers": 1, "mapper": "python", "use_native": False,
             "backend": "cpu"},
    "jax": {"num_chunks": 6, "batch_size": 1 << 12, "key_capacity": 1 << 12,
            "num_map_workers": 1, "mapper": "python", "use_native": False,
            "num_shards": 1},
}


def test_warm_jobs_zero_compile_delta(servers, clients):
    """Back-to-back same-shape jobs through the port's server: every job
    after the first compiles nothing (the launch ledger's signatures are
    process-global), per job through the overlay."""
    _srvs, tmp = servers
    c = clients["port"]
    corpus = _write_corpus(tmp / "warm.txt", lines=300)
    docs = [c.wait(c.submit("wordcount", corpus,
                            config=OVERRIDES["port"])["id"], timeout_s=120)
            for _ in range(3)]
    assert [d["state"] for d in docs] == ["done"] * 3
    assert all(d["records_in"] == docs[0]["records_in"] for d in docs)
    assert docs[1]["compiles"] == 0 and docs[2]["compiles"] == 0
    with open(docs[1]["artifacts"]["metrics_out"]) as f:
        assert json.load(f)["gauges"]["compile/total_compiles"] == 0


def test_concurrent_jobs_oracle_exact_disjoint(servers, clients):
    from map_oxidize_tpu.obs import ledger as jax_ledger
    from map_oxidize_tpu.workloads.reference_model import wordcount_model

    srvs, tmp = servers
    c = clients["port"]
    ca = _write_corpus(tmp / "ca.txt", lines=150, words=[b"aa", b"bb", b"cc"])
    cb = _write_corpus(tmp / "cb.txt", lines=250,
                       words=[b"xx", b"yy", b"zz", b"ww"])
    outs = [str(tmp / "out_a.txt"), str(tmp / "out_b.txt")]
    subs = [c.submit("wordcount", p, config=OVERRIDES["port"], output=o)
            for p, o in zip((ca, cb), outs)]
    da, db = (c.wait(s["id"], timeout_s=120) for s in subs)
    assert da["state"] == "done" and db["state"] == "done"
    for corpus, out in ((ca, outs[0]), (cb, outs[1])):
        with open(corpus, "rb") as f:
            oracle = wordcount_model([f.read()])
        got = {}
        with open(out, "rb") as f:
            for line in f:
                w, _, n = line.rstrip(b"\n").rpartition(b" ")
                got[w] = int(n)
        assert got == dict(oracle)
    for d in (da, db):
        with open(d["artifacts"]["metrics_out"]) as f:
            assert json.load(f)["gauges"]["records_in"] == d["records_in"]
    assert da["records_in"] != db["records_in"]
    # each job appended its own entry, read by the JAX ledger
    entries = jax_ledger.read(srvs["port"].scheduler.ledger_dir)
    assert {da["records_in"], db["records_in"]} <= {
        e["metrics"]["records_in"] for e in entries}


def test_both_servers_serve_the_same_jobs_alike(servers, clients):
    """The same word count and k-means submitted to a server of each
    package: identical output bytes, centroids within the k-means
    tolerance (atol 1e-4), equal ``/jobs`` row key sets."""
    _srvs, tmp = servers
    corpus = _write_corpus(tmp / "same.txt", lines=260)
    pts = tmp / "pts.npy"
    rng = np.random.default_rng(5)
    centres = rng.normal(scale=20.0, size=(4, 6))
    np.save(pts, (centres[rng.integers(0, 4, 3000)]
                  + rng.normal(size=(3000, 6))).astype(np.float32))
    rows, outs = {}, {}
    for name, c in clients.items():
        wc_out = str(tmp / f"wc_{name}.txt")
        km_out = str(tmp / f"km_{name}.npy")
        km_cfg = {"kmeans_k": 4, "kmeans_iters": 3,
                  **({"backend": "cpu"} if name == "port"
                     else {"num_shards": 1})}
        wc = c.submit("wordcount", corpus, config=OVERRIDES[name],
                      output=wc_out)
        km = c.submit("kmeans", str(pts), config=km_cfg, output=km_out)
        rows[name] = [c.wait(j["id"], timeout_s=120) for j in (wc, km)]
        outs[name] = (wc_out, km_out)
        assert [r["state"] for r in rows[name]] == ["done", "done"]
    with open(outs["port"][0], "rb") as f, open(outs["jax"][0], "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_allclose(np.load(outs["port"][1]),
                               np.load(outs["jax"][1]), atol=1e-4, rtol=0)
    for mine, ref in zip(rows["port"], rows["jax"]):
        assert set(mine) == set(ref)
        assert set(mine["artifacts"]) == set(ref["artifacts"])
    docs = {n: c.jobs() for n, c in clients.items()}
    assert set(docs["port"]) == set(docs["jax"])
    assert set(docs["port"]["hbm"]) == set(docs["jax"]["hbm"])
    assert set(docs["port"]["jobs"][0]) == set(docs["jax"]["jobs"][0])


def test_live_job_rows_carry_the_compile_overlay(tmp_path):
    """A running job's ``/jobs`` row reads its live launch-ledger overlay
    (compiles and dispatches routed to it), as the JAX row does."""
    from map_oxidize_tpu_torch.obs.compile import observed

    prog = observed("serve/test_live_prog", lambda x: x + 1)
    release = threading.Event()
    inside = threading.Event()

    def runner(config, workload, on_obs):
        import torch

        obs = Obs.from_config(config)
        on_obs(obs)
        with obs.recording(config, workload):
            for _ in range(3):
                prog(torch.arange(4))
            inside.set()
            release.wait(30)
        obs.finish(config, workload)

        class _R:
            metrics = {"records_in": 1}

        return _R()

    corpus = _write_corpus(tmp_path / "c.txt", lines=5)
    sched = Scheduler(_serve_cfg(tmp_path, workers=1), runner=runner)
    sched.start()
    try:
        job = sched.submit("wordcount", corpus)
        assert inside.wait(30)
        row = sched.job_doc(job.id)
        assert row["state"] == "running"
        assert row["dispatches"] == 3 and row["compiles"] in (0, 1)
        assert {"elapsed_s", "phase", "rows", "rows_per_sec"} <= set(row)
        release.set()
        assert sched.wait(job.id, timeout=30).state == "done"
    finally:
        release.set()
        sched.shutdown()


def test_a_cuda_job_on_a_host_without_a_card_fails_named(servers, clients):
    """``backend='cuda'`` (the default) on a host with no card fails in the
    driver, and its row names the error: nothing re-runs on the CPU.  A
    served ``num_shards=2`` word count on the CPU runs on the sharded
    engine and writes ``run_job``'s bytes."""
    _srvs, tmp = servers
    c = clients["port"]
    corpus = _write_corpus(tmp / "nocard.txt", lines=5)
    row = c.wait(c.submit("wordcount", corpus, config={"num_chunks": 1})
                 ["id"], timeout_s=60)
    assert row["state"] == "failed"
    assert "no CUDA device" in row["reason"]
    assert os.listdir(row["artifacts"]["crash_dir"])
    out = str(tmp / "sharded_served.txt")
    row = c.wait(c.submit("wordcount", corpus, output=out, config=dict(
        OVERRIDES["port"], num_shards=2))["id"], timeout_s=60)
    assert row["state"] == "done", row.get("reason")
    want = tmp / "sharded_direct.txt"
    from map_oxidize_tpu_torch.runtime import run_job

    r = run_job(JobConfig(input_path=corpus, output_path=str(want),
                          **dict(OVERRIDES["port"], num_shards=2)),
                "wordcount")
    assert r.metrics["shuffle/exchanges"] >= 1
    with open(out, "rb") as f:
        assert f.read() == want.read_bytes()


def test_jobs_table_renders_in_the_jax_panel(servers, clients):
    from map_oxidize_tpu.obs.cli import render_jobs

    c = clients["port"]
    doc = c.jobs()
    assert doc["schema"] == "moxt-jobs-v1"
    assert doc["queue"]["max"] == 16
    assert doc["counts"].get("done", 0) >= 2
    assert {"budget_bytes", "reserved_bytes",
            "measured_live_bytes"} <= set(doc["hbm"])
    assert any(cc["hits"] >= 1 for cc in doc["corpora"])
    frame = render_jobs(doc)
    assert "jobs (" in frame and doc["jobs"][0]["id"] in frame
    assert "/jobs" in c._request("/")["endpoints"]
    # the server's own registry: latency histograms, kernel launches
    status = c.status()
    assert status["meta"]["workload"] == "serve"
    assert "attrib" not in status
    assert "hbm/budget_bytes" not in status["hbm"]   # no card here


def test_http_submit_validation(servers, clients):
    from map_oxidize_tpu_torch.serve.client import ServeError

    _srvs, tmp = servers
    c = clients["port"]
    with pytest.raises(ServeError, match="unknown workload"):
        c.submit("terasort", str(tmp / "warm.txt"))
    with pytest.raises(ServeError, match="reserved"):
        c.submit("wordcount", str(tmp / "warm.txt"), config={"obs_port": 5})
    with pytest.raises(ServeError, match="unknown config"):
        c.submit("wordcount", str(tmp / "warm.txt"), config={"nope": "x"})
    # a remote-stage field is a known override: its value is validated
    with pytest.raises(ServeError, match="remote_stage_timeout_s"):
        c.submit("wordcount", str(tmp / "warm.txt"),
                 config={"remote_stage_timeout_s": 0})
    with pytest.raises(ServeError, match="unknown job"):
        c.cancel("job-9999")
    rejected = c.submit("wordcount", str(tmp / "nope.txt"))
    assert rejected["state"] == "rejected"
    assert "input_not_found" in rejected["reason"]


def test_http_shutdown_requests_drain(tmp_path):
    """POST /shutdown flips the scheduler to draining and wakes
    serve_forever, which drains, stops the plane and removes the port
    record."""
    import urllib.error
    import urllib.request

    from map_oxidize_tpu_torch.serve.client import ServeClient
    from map_oxidize_tpu_torch.serve.server import ResidentServer

    release = threading.Event()
    release.set()
    srv = ResidentServer(_serve_cfg(tmp_path, workers=1),
                         runner=_held_runner(release)).start()
    record = os.path.join(srv.cfg.spool_dir, "obs_port.json")
    with open(record) as f:
        assert json.load(f)["url"] == srv.url
    c = ServeClient(srv.url)
    corpus = _write_corpus(tmp_path / "c.txt", lines=5)
    assert c.wait(c.submit("wordcount", corpus)["id"],
                  timeout_s=30)["state"] == "done"
    assert c.shutdown(drain=True)["draining"] is True
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert not os.path.exists(record)
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(srv.url + "/jobs", timeout=2)


def test_serve_and_submit_run_from_the_command_line(tmp_path):
    """``python -m map_oxidize_tpu_torch serve`` in a subprocess, driven
    by ``submit``: a CPU word count done, then a drain; the process exits
    0 and leaves one ledger entry."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    spool = tmp_path / "spool"
    corpus = _write_corpus(tmp_path / "c.txt", lines=50)
    proc = subprocess.Popen(
        [sys.executable, "-m", "map_oxidize_tpu_torch", "serve", "--port",
         "0", "--workers", "1", "--spool-dir", str(spool), "-q"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _until(lambda: (spool / "obs_port.json").is_file(), timeout=60)
        url = json.loads((spool / "obs_port.json").read_text())["url"]

        def submit(*args):
            return subprocess.run(
                [sys.executable, "-m", "map_oxidize_tpu_torch", "submit",
                 "--url", url, *args], env=env, capture_output=True,
                text=True, timeout=120)

        r = submit("wordcount", corpus, "--wait", "--output",
                   str(tmp_path / "out.txt"), "--set", "backend=cpu",
                   "--set", "num_chunks=2")
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["state"] == "done"
        assert (tmp_path / "out.txt").read_bytes()
        assert submit("--shutdown").returncode == 0
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert not (spool / "obs_port.json").exists()
    with open(spool / "ledger" / "ledger.jsonl") as f:
        assert len(f.readlines()) == 1
