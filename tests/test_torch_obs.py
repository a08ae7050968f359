"""The port's observability bundle against the JAX package's: the same
seeded jobs through both packages (word count with the native, the Python
and the device map, word count resumed from a checkpoint, k-means in its
``device``, ``stream_device`` and ``stream`` modes, bigram through the
collect reduce, the inverted index, distinct, and sort, join and
sessionize) report the same metric keys (the launch ledger's
``compile/*`` and ``xprof/*``, the plan's, the dispatch resolver's and the
critical path's among them), the same exact counts and data-plane audit,
the same phases in the trace and the same metrics-document sections,
apart from the port's own keys (``PORT_OWN``); ``ALLOWLIST`` (surfaces not
ported yet) is empty.  Each pair of jobs starts from fresh launch ledgers
and jit caches in both packages, so what compiles is the job's own.  Unit
cases hold ``MetricsRegistry``, ``Tracer``, ``attrib.compute``, the
data-plane digests and ``Heartbeat`` to the JAX functions on the same
inputs; the flight recorder, the CLI flags and the ``torch.profiler``
trace are checked on the CPU."""

import itertools
import json
import logging
import sys
import threading
import types

import numpy as np
import pytest
import torch

from map_oxidize_tpu.cli import build_parser as jax_build_parser
from map_oxidize_tpu.cli import main as jax_cli_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import attrib as jax_attrib
from map_oxidize_tpu.obs import dataplane as jax_dataplane
from map_oxidize_tpu.obs.heartbeat import Heartbeat as JaxHeartbeat
from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from map_oxidize_tpu.obs.metrics import format_bytes as jax_format_bytes
from map_oxidize_tpu.obs.trace import Tracer as JaxTracer
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.workloads.distinct import hll_estimate as jax_hll
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.api import Mapper
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs, attrib, dataplane
from map_oxidize_tpu_torch.obs.heartbeat import Heartbeat
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry, format_bytes
from map_oxidize_tpu_torch.obs.trace import Tracer
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
from map_oxidize_tpu_torch.workloads import kmeans as tkm
from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

torch.set_num_threads(2)

#: keys of the JAX package's surfaces that the port has not ported yet,
#: by prefix (ending in "/") or exact name, with the reason: none left
ALLOWLIST: dict = {}
#: ... except these, which the port emits with the same meaning
NOT_ALLOWLISTED: set = set()
#: metrics-document sections of the same surfaces
ALLOWLISTED_SECTIONS: set = set()
#: keys only the port emits, with the reason
PORT_OWN = {
    "accumulator_device": "where the word-count or bigram reduce ran (no "
                          "fallback)",
    "device": "where the k-means fit ran (no fallback)",
    "obs/envelope_ms": "the job envelope (obs/setup + obs/finish), which "
                       "no other metric of the job's wall covers",
    **{f"device_map/{step}_ms": "the device map's host step per chunk, "
                                "which the phase's wall alone cannot split"
       for step in ("read", "stage", "enqueue", "fetch_wait", "dict")},
    "device_map/cut_fallbacks": "windows whose cut at whitespace needed "
                                "more than the scan of their tail",
    "device_map/carry_bytes": "bytes moved from a window's tail to the "
                              "next staging slot's head",
    "device_map/overflow_fetches": "chunks whose unique keys needed the "
                                   "overflow fetch past the packed row",
    "device_map/overflow_ms": "the overflow fetches, inside the dict step",
    "device_map/chunk_keys": "the chunks' unique keys, summed",
    "device_map/readback_ms": "the accumulator's readback in finalize",
    "device_map/top_k_ms": "the top-k in finalize",
    "device_map/materialize_ms": "the one build of the device map's "
                                 "hash -> bytes dict from its native "
                                 "dictionary, when a consumer iterates "
                                 "the counts",
    "device_map/write_ms": "the native call that looks up, sorts, formats "
                           "and writes the device map's rows, inside the "
                           "write phase",
    "device_map/write_rows": "the rows that the native writer wrote, which "
                             "no metric of the job's wall covers",
    "engine/grow_ms": "the accumulator's growths, host side",
    "kmeans/read_points_ms": "the block loop of the points' transfer (the "
                             "reads, the copy launches, the slot waits), "
                             "the first half of time/transfer_s",
    "kmeans/copy_points_ms": "the drain of the points' copies to the device "
                             "and its sync, the second half of "
                             "time/transfer_s",
    "kmeans/read_blocks": "the blocks of the resident points read straight "
                          "from the file into a host slot (0 where they "
                          "were copied from an array)",
    "kmeans/assign_sum_calls": "the fused assign + sum's calls in a device "
                               "fit, which the roofline reads per launch",
    **{f"kmeans/plan_{key}": "the CUDA kernel's launch plan (on a card "
                             "only)"
       for key in ("grid", "resident", "acc_in_smem", "k_pad")},
}


def _allowlisted(key: str) -> bool:
    if key.rstrip("/") in NOT_ALLOWLISTED:
        return False
    return any(key == name or (name.endswith("/") and key.startswith(name))
               for name in ALLOWLIST)


# --- the jobs ---------------------------------------------------------------


def _corpus(seed=0, vocab=400, lines=3000):
    rng = np.random.default_rng(seed)
    words = [b"w%dx" % i for i in range(vocab)]
    z = rng.zipf(1.3, size=(lines, 12)) % vocab
    return b"\n".join(b" ".join(words[j] for j in row) for row in z) + b"\n"


def _points(seed=1, n=3000, d=4, k=4):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:k] = centres
    return pts


WC = dict(chunk_bytes=16384, batch_size=4096)
KM = dict(kmeans_k=4, kmeans_iters=3, chunk_bytes=2048)
JOBS = {
    "wordcount_native": ("wordcount", dict(WC, mapper="native")),
    "wordcount_python": ("wordcount", dict(WC, mapper="python",
                                           num_map_workers=1)),
    "wordcount_resumed": ("wordcount", dict(WC, mapper="native")),
    "wordcount_no_audit": ("wordcount", dict(WC, mapper="native",
                                             data_audit=False)),
    "wordcount_device": ("wordcount", dict(WC, mapper="device",
                                           device_chunk_keys=4096)),
    "kmeans_device": ("kmeans", dict(KM, mapper="device")),
    "kmeans_stream_device": ("kmeans", dict(KM, kmeans_device_fit_bytes=64,
                                            dispatch_batch=2)),
    "kmeans_stream": ("kmeans", dict(KM, mapper="native")),
    "bigram_collect": ("bigram", dict(WC, mapper="native")),
    "invertedindex": ("invertedindex", dict(WC)),
    "invertedindex_demoted": ("invertedindex",
                              dict(WC, collect_max_rows=10_000,
                                   shuffle_transport="hybrid")),
    "distinct": ("distinct", dict(WC)),
    "sort": ("sort", dict(WC)),
    "sort_demoted": ("sort", dict(WC, collect_max_rows=2000,
                                  shuffle_transport="hybrid")),
    "join": ("join", dict(WC)),
    "sessionize": ("sessionize", dict(WC, session_gap=500)),
}
#: the jobs that read a text corpus and write a text result
TEXT = ("wordcount", "bigram", "invertedindex", "distinct")
#: the jobs that read (u64 key, u64 payload) records
RECORDS = ("sort", "join", "sessionize")


def _records(seed=2, n=6000, keys=700):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, keys, n, dtype=np.uint64),
                     rng.integers(0, 1 << 40, n, dtype=np.uint64)], axis=1)


def _fresh_ledgers():
    """Both packages' launch ledgers, jit caches and dispatch memos as in a
    fresh process, so a job's compiles are its own whatever ran before."""
    import jax

    from map_oxidize_tpu.obs.compile import LEDGER as JAX_LEDGER
    from map_oxidize_tpu.runtime import dispatch as jax_dispatch
    from map_oxidize_tpu_torch.obs.compile import LEDGER
    from map_oxidize_tpu_torch.runtime import dispatch

    jax.clear_caches()
    JAX_LEDGER.programs.clear()
    LEDGER.reset()
    jax_dispatch._auto_cache.clear()
    dispatch._auto_cache.clear()


def _run_pair(tmp, job):
    """Run ``job`` through both packages; returns per package the result,
    the ``metrics_out`` document and the ``trace_out`` events."""
    _fresh_ledgers()
    workload, kw = JOBS[job]
    if workload in TEXT:
        inp = tmp / "corpus.txt"
        inp.write_bytes(_corpus())
    elif workload in RECORDS:
        inp = tmp / "recs.npy"
        np.save(inp, _records())
        right = tmp / "right.npy"
        np.save(right, _records(seed=3, n=5000))
        kw = dict(kw, join_input_path=str(right)) if job == "join" else kw
    else:
        inp = tmp / "pts.npy"
        np.save(inp, _points())
    out = {}
    for pkg, cfg_cls, run in (("port", JobConfig, run_job),
                              ("jax", JaxJobConfig, jax_run_job)):
        extra = {"num_shards": 1} if pkg == "jax" else {}
        common = dict(input_path=str(inp), backend="cpu", metrics=False,
                      **extra, **kw)
        if job == "wordcount_resumed":
            # a spill of every chunk, cut back to its first two: the
            # resumed run replays two and maps the rest
            ck = tmp / f"ck_{pkg}"
            run(cfg_cls(output_path="", checkpoint_dir=str(ck),
                        keep_intermediates=True, **common), workload)
            spilled = sorted(ck.glob("chunk_*.npz"))
            assert len(spilled) >= 4
            for f in spilled[2:]:
                f.unlink()
            common["checkpoint_dir"] = str(ck)
        m_path, t_path = tmp / f"{pkg}_m.json", tmp / f"{pkg}_t.json"
        r = run(cfg_cls(output_path=str(tmp / f"{pkg}.out"),
                        metrics_out=str(m_path), trace_out=str(t_path),
                        **common), workload)
        out[pkg] = (r, json.loads(m_path.read_text()),
                    json.loads(t_path.read_text()))
    assert ((tmp / "port.out").read_bytes() == (tmp / "jax.out").read_bytes()
            if workload in TEXT + RECORDS else True)
    return out


@pytest.fixture(scope="module", params=list(JOBS))
def pair(request, tmp_path_factory):
    return request.param, _run_pair(tmp_path_factory.mktemp(request.param),
                                    request.param)


def test_key_sets_match_the_jax_package(pair):
    job, runs = pair
    port = set(runs["port"][0].metrics)
    jax = set(runs["jax"][0].metrics)
    assert {k for k in port - jax} == set(PORT_OWN) & port
    assert {k for k in jax - port if not _allowlisted(k)} == set()
    assert not any(_allowlisted(k) for k in port)
    if job.startswith("kmeans"):
        assert {"time/iterate_s", "time/write_s", "device/compute_ms/count",
                "attrib/init_ms", "mem/host_rss_bytes"} <= port
        assert "time/iter_s" in port if job == "kmeans_device" else True
    elif job == "bigram_collect":
        assert {"records_per_sec", "shuffle/transport", "feed_block_ms/count",
                "data/conservation_checks", "device/compute_ms/count",
                "pipeline/overlap_ratio"} <= port
    elif job.startswith("invertedindex"):
        assert {"shuffle/transport", "time/map+collect_s",
                "time/sort+postings_s", "grouped_finalize", "pairs",
                "data/conservation_checks", "feed_block_ms/count"} <= port
        assert ({"demote/events", "demote/rows", "spill/rows", "spill/bytes",
                 "spill/buckets", "spilled_pairs",
                 "data/spill_bucket_imbalance"} <= port) == (
                     job == "invertedindex_demoted")
    elif job == "distinct":
        assert {"registers_filled", "time/map+reduce_s",
                "time/finalize_s", "feed_block_ms/count"} <= port
    elif job == "wordcount_device":
        assert {"time/map+reduce_s", "time/finalize_s", "time/write_s",
                "device/compute_ms/count", "records_in", "chunks",
                "distinct_keys", "accumulator_device"} <= port
        assert "records_per_sec" in port
        assert not {"feed_block_ms/count", "device_rows_fed"} & port
    elif JOBS[job][0] in RECORDS:
        assert {"shuffle/transport", "time/map+route_s", "time/merge_s",
                "attrib/host_sort_ms", "feed_block_ms/count",
                "pipeline/overlap_ratio", "records_in", "chunks"} <= port
        assert ("time/sample_s" in port) == (job.startswith("sort"))
        assert ({"demote/events", "spill/rows"} <= port) == (
            job == "sort_demoted")
    else:
        assert {"records_per_sec", "time/split_s", "feed_block_ms/count",
                "engine/flush_ms/p95", "engine/device_put_bytes",
                "device/compute_ms/max", "mem/host_rss_peak_bytes"} <= port
    if job == "wordcount_resumed":
        assert runs["port"][0].metrics["checkpoint/chunks_replayed"] == 2


def test_counts_and_data_audit_match_exactly(pair):
    job, runs = pair
    pm, jm = runs["port"][0].metrics, runs["jax"][0].metrics
    exact = [k for k in jm if k.startswith("data/") or k in (
        "pipeline/chunks", "pipeline/depth", "engine/flushes",
        "engine/device_put_bytes", "records_in", "chunks", "distinct_keys",
        "device_rows_fed", "kmeans_mode", "points", "iters",
        "checkpoint/chunks_replayed", "dispatch/batch", "shuffle/transport",
        "pairs", "distinct_terms", "grouped_finalize", "registers_filled",
        "demote/events", "demote/rows", "spill/rows", "spill/buckets",
        "spilled_pairs", "rows_out", "join/matches", "join/left_rows",
        "join/right_rows", "sessions/count")]
    assert exact
    assert {k: pm[k] for k in exact} == {k: jm[k] for k in exact}
    if job.startswith(("wordcount", "bigram")) and job not in (
            "wordcount_no_audit", "wordcount_device"):
        assert pm["data/conservation_violations"] == 0
        assert pm["data/conservation_checks"] == 3
        assert runs["port"][1]["data"] == runs["jax"][1]["data"]
    elif job.startswith("invertedindex"):
        # the pair digest: one multiset check over every partition, and
        # the spill's round trip when the job demoted
        assert pm["data/conservation_violations"] == 0
        assert pm["data/conservation_checks"] == (
            2 if job == "invertedindex_demoted" else 1)
        assert runs["port"][1]["data"] == runs["jax"][1]["data"]
    elif job == "sort_demoted":
        # the spill's bucket balance is the only audit a sort reports
        assert [k for k in pm if k.startswith("data/")] == [
            "data/spill_bucket_imbalance"]
    else:
        assert not any(k.startswith("data/") for k in pm)


def test_trace_holds_the_phases_in_jax_order(pair):
    job, runs = pair
    (pr, _, pt), (jr, _, jt) = runs["port"], runs["jax"]
    assert pt[0]["name"] == "moxt_meta" and jt[0]["name"] == "moxt_meta"
    assert set(pt[0]["args"]) == set(jt[0]["args"])
    assert pt[0]["args"]["workload"] == jt[0]["args"]["workload"]

    def phases(trace):
        return [e["name"] for e in trace if e["name"].startswith("phase/")]

    assert phases(pt) == phases(jt)
    # the sort writes its records inside the merge, as in the JAX package
    assert phases(pt)[-1] == ("phase/merge" if job.startswith("sort")
                              else "phase/write")
    assert pr.trace == pt  # the result carries the written events
    # the producer thread's spans land on a tid of their own
    prod = {e["tid"] for e in pt if e["name"].endswith("/produce")}
    driver = {e["tid"] for e in pt if e["name"].startswith("phase/")}
    if job not in ("kmeans_device", "wordcount_device"):
        assert prod and len(driver) == 1 and not prod & driver


def test_metrics_document_has_the_jax_sections(pair):
    job, runs = pair
    pdoc, jdoc = runs["port"][1], runs["jax"][1]
    assert set(pdoc) == set(jdoc) - ALLOWLISTED_SECTIONS
    assert set(pdoc["meta"]) == set(jdoc["meta"])
    assert pdoc["meta"]["workload"] == jdoc["meta"]["workload"]
    assert set(pdoc["attrib"]) == set(jdoc["attrib"])
    assert list(pdoc["attrib"]["buckets"]) == list(jdoc["attrib"]["buckets"])
    for sec in ("counters", "gauges", "histograms"):
        keys = {k for k in jdoc[sec] if not _allowlisted(k)
                and not _allowlisted(k + "/")}
        assert set(pdoc[sec]) - set(PORT_OWN) == keys
    assert set(pdoc["phases_s"]) == set(jdoc["phases_s"])


# --- the flight recorder ----------------------------------------------------


def _raise_after(monkeypatch, module, name, i):
    real = getattr(module, name)

    def dying(*a, on_iter=None, **kw):
        def hook(j, c):
            on_iter(j, c)
            if j == i:
                raise KeyboardInterrupt("simulated kill")
        return real(*a, on_iter=hook, **kw)

    monkeypatch.setattr(module, name, dying)


def test_a_raising_job_leaves_the_crash_bundle_and_partial_metrics(
        tmp_path, monkeypatch):
    """A streamed fit whose ``on_iter`` raises after iteration 1, in both
    packages: the exception propagates; the crash bundle holds the same
    files; the partial metrics and trace are at their paths, the phase
    span closed and marked."""
    import map_oxidize_tpu.parallel.kmeans as jax_pk

    _raise_after(monkeypatch, tkm, "kmeans_fit_streamed_device", 1)
    _raise_after(monkeypatch, jax_pk, "kmeans_fit_streamed", 1)
    path = tmp_path / "pts.npy"
    np.save(path, _points())
    docs = {}
    for pkg, cfg_cls, run in (("port", JobConfig, run_job),
                              ("jax", JaxJobConfig, jax_run_job)):
        extra = {"num_shards": 1} if pkg == "jax" else {}
        crash = tmp_path / f"crash_{pkg}"
        cfg = cfg_cls(input_path=str(path), backend="cpu", metrics=False,
                      output_path="", crash_dir=str(crash),
                      checkpoint_dir=str(tmp_path / f"ck_{pkg}"),
                      metrics_out=str(tmp_path / f"{pkg}_m.json"),
                      trace_out=str(tmp_path / f"{pkg}_t.json"),
                      kmeans_device_fit_bytes=64, **extra, **KM)
        with pytest.raises(KeyboardInterrupt, match="simulated kill"):
            run(cfg, "kmeans")
        (bundle,) = crash.iterdir()
        files = sorted(p.name for p in bundle.iterdir())
        metrics = json.loads((tmp_path / f"{pkg}_m.json").read_text())
        trace = json.loads((tmp_path / f"{pkg}_t.json").read_text())
        err = json.loads((bundle / "error.json").read_text())
        docs[pkg] = files, metrics, trace, err
        assert metrics == json.loads((bundle / "metrics.json").read_text())
        assert metrics["gauges"]["aborted"] is True
        assert trace[0]["args"]["aborted"] is True
        (it,) = [e for e in trace if e["name"] == "phase/iterate"]
        assert "KeyboardInterrupt: simulated kill" in it["args"]["error"]
    assert docs["port"][0] == docs["jax"][0] == [
        "error.json", "metrics.json", "trace.json"]
    assert set(docs["port"][3]) == set(docs["jax"][3])
    assert set(docs["port"][1]) == set(docs["jax"][1]) - ALLOWLISTED_SECTIONS


class _FailingMapper(Mapper):
    """The Python word-count map that raises in its third chunk."""

    def __init__(self):
        self.inner, _ = make_wordcount("ascii", use_native=False)
        self.value_shape = self.inner.value_shape
        self.value_dtype = self.inner.value_dtype
        self.keys_have_dictionary = True
        self.calls = 0

    def map_chunk(self, chunk):
        self.calls += 1
        if self.calls == 3:
            raise ValueError("mapper failed in chunk 3")
        return self.inner.map_chunk(chunk)


def test_a_producer_thread_failure_reaches_the_flight_recorder(tmp_path):
    """The map raises in the prefetch thread: the error reaches the
    consumer and the flight recorder, the producer's span carries it on
    the producer's tid, and the bundle is written."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(_corpus())
    _, reducer = make_wordcount("ascii", use_native=False)
    cfg = JobConfig(input_path=str(inp), backend="cpu", metrics=False,
                    output_path="", num_map_workers=1, max_retries=0,
                    crash_dir=str(tmp_path / "crash"),
                    trace_out=str(tmp_path / "t.json"), **WC)
    with pytest.raises(Exception, match="mapper failed in chunk 3"):
        run_wordcount_job(cfg, _FailingMapper(), reducer)
    trace = json.loads((tmp_path / "t.json").read_text())
    (failed,) = [e for e in trace if e["name"] == "map/produce"
                 and "error" in e["args"]]
    assert failed["tid"] != 0 and failed["args"]["seq"] == 2
    (mr,) = [e for e in trace if e["name"] == "phase/map+reduce"]
    assert "mapper failed in chunk 3" in mr["args"]["error"]
    assert len(list((tmp_path / "crash").iterdir())) == 1
    assert not [t for t in threading.enumerate()
                if t.name == "map-prefetch" and t.is_alive()]


def test_profiler_trace_dir_and_no_leak_after_an_abort(tmp_path,
                                                       monkeypatch):
    """``trace_dir`` writes a ``torch.profiler`` Chrome trace and counts
    ``profile/captures``; a job that aborts under it leaves no profiler
    running (the next traced job starts one)."""
    path = tmp_path / "pts.npy"
    np.save(path, _points())
    cfg = dict(input_path=str(path), backend="cpu", metrics=False,
               output_path="", mapper="device", **KM)
    real = tkm.kmeans_fit_device
    monkeypatch.setattr(tkm, "kmeans_fit_device", lambda *a, **k: (
        _ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        run_job(JobConfig(trace_dir=str(tmp_path / "t0"), **cfg), "kmeans")
    monkeypatch.setattr(tkm, "kmeans_fit_device", real)
    assert not list((tmp_path / "t0").iterdir())
    r = run_job(JobConfig(trace_dir=str(tmp_path / "t1"), **cfg), "kmeans")
    assert r.metrics["profile/captures"] == 1
    (f,) = (tmp_path / "t1").iterdir()
    events = json.loads(f.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_a_cpu_job_initialises_no_cuda(tmp_path):
    path = tmp_path / "pts.npy"
    np.save(path, _points())
    r = run_job(JobConfig(input_path=str(path), backend="cpu", metrics=False,
                          output_path="", mapper="device", **KM), "kmeans")
    assert not torch.cuda.is_initialized()
    assert not [k for k in r.metrics if k.startswith("mem/device")]


# --- the CLI ----------------------------------------------------------------


FLAGS = ["--metrics-out", "--trace-out", "--trace-dir", "--crash-dir",
         "--progress", "--progress-interval", "--no-data-audit",
         "--chunk-mb", "--kmeans-fit-bytes", "--plan", "--calib-dir",
         "--calib-min-samples", "--hbm-sample-interval", "--stall-factor",
         "--ledger-dir", "--obs-port", "--obs-sample-interval",
         "--obs-spool", "--slo-rules", "--incident-dir", "--profile-dir",
         "--host-sample-hz", "--no-native", "--num-shards",
         "--exchange-collective", "--dist-coordinator", "--dist-processes",
         "--dist-process-id", "--remote-stage-dir",
         "--remote-stage-timeout"]


@pytest.mark.parametrize("flag", FLAGS)
def test_cli_flag_has_the_jax_name_and_default(flag):
    def action(parser):
        (a,) = [a for a in parser._actions if flag in a.option_strings]
        return a.dest, a.default, type(a).__name__

    assert action(cli.build_parser()) == action(jax_build_parser())


def test_cli_no_native_gives_the_jax_cli_s_bytes(tmp_path, monkeypatch):
    """``--no-native`` with ``--mapper auto`` maps in Python and clears
    ``use_native`` in both CLIs (JAX ``cli.py:338-340``); the two
    ``final_result.txt`` files are byte-identical, and the flag's config
    mapping is the JAX one."""
    inp = tmp_path / "c.txt"
    inp.write_bytes(_corpus())
    monkeypatch.chdir(tmp_path)
    args = ["wordcount", str(inp), "--no-native", "--num-chunks", "3",
            "-q"]
    assert cli.main(args + ["--backend", "cpu", "--output", "t.txt",
                            "--metrics-out", "t.json"]) == 0
    assert jax_cli_main(args + ["--num-shards", "1", "--output",
                                "j.txt"]) == 0
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    for argv in (args, args + ["--mapper", "native"]):
        mine = cli.config_from_args(cli.build_parser().parse_args(argv))
        from map_oxidize_tpu.cli import config_from_args as jax_config

        ref = jax_config(jax_build_parser().parse_args(argv))
        assert (mine.mapper, mine.use_native) == (ref.mapper,
                                                  ref.use_native)
    assert (mine.mapper, mine.use_native) == ("native", False)


def test_cli_kmeans_fit_bytes_reaches_stream_device_like_the_jax_cli(
        tmp_path, monkeypatch):
    """``--kmeans-fit-bytes`` past the points routes ``auto`` to
    ``stream_device`` in both CLIs (``kmeans_mode`` in ``--metrics-out``);
    the two ``final_result.txt`` centroid files agree within the k-means
    tolerance (rtol 1e-5, atol 1e-4)."""
    path = tmp_path / "pts.npy"
    np.save(path, _points(n=2000))
    monkeypatch.chdir(tmp_path)
    args = ["kmeans", str(path), "--backend", "cpu", "--kmeans-k", "4",
            "--kmeans-iters", "2", "--kmeans-fit-bytes", "64",
            "--chunk-mb", "1", "-q"]
    assert cli.main(args + ["--output", "t_final_result.txt",
                            "--metrics-out", "t.json"]) == 0
    assert jax_cli_main(args + ["--num-shards", "1",
                                "--output", "j_final_result.txt",
                                "--metrics-out", "j.json"]) == 0
    for m in ("t.json", "j.json"):
        assert json.loads((tmp_path / m).read_text())["gauges"][
            "kmeans_mode"] == "stream_device"
    np.testing.assert_allclose(np.load(tmp_path / "t_final_result.txt"),
                               np.load(tmp_path / "j_final_result.txt"),
                               rtol=1e-5, atol=1e-4)


def test_cli_writes_metrics_trace_and_progress(tmp_path, monkeypatch):
    inp = tmp_path / "c.txt"
    inp.write_bytes(_corpus())
    monkeypatch.chdir(tmp_path)
    lines = []
    sink = logging.Handler()
    sink.emit = lambda rec: lines.append(rec.getMessage())
    hb_log = logging.getLogger("moxt.torch.obs.heartbeat")
    hb_log.addHandler(sink)
    try:
        assert cli.main(["wordcount", str(inp), "--backend", "cpu",
                         "--metrics-out", "m.json", "--trace-out", "t.json",
                         "--progress", "--progress-interval", "0.000001",
                         "--no-data-audit"]) == 0
    finally:
        hb_log.removeHandler(sink)
    doc = json.loads((tmp_path / "m.json").read_text())
    assert "data" not in doc and doc["meta"]["workload"] == "wordcount"
    assert doc["gauges"]["records_in"] > 0
    trace = json.loads((tmp_path / "t.json").read_text())
    assert [e["name"] for e in trace if e["name"].startswith("phase/")] == [
        "phase/split", "phase/map+reduce", "phase/finalize", "phase/write"]
    assert any(line.startswith("progress: phase=map+reduce")
               for line in lines)
    assert "where=" in lines[-1]


# --- units against the JAX functions ----------------------------------------


def _fill_registry(reg, case):
    if case == "counters_and_gauges":
        for i in range(50):
            reg.count("a/b", i)
            reg.count("c")
            reg.set("g", i * 0.5)
            reg.gauge_max("w", (i * 37) % 11)
    elif case == "histogram_decimation":
        for i in range(20_000):
            reg.observe("h", (i * 7919) % 1009 / 3.0)
        reg.observe("one", 4.25)
    elif case == "records_per_sec":
        reg.set("records_in", 12345)
        reg.phases.update({"map+reduce": 0.75, "finalize": 0.25,
                           "write": 0.123456789})
    elif case == "no_throughput_without_phases":
        reg.set("records_in", 10)
        reg.phases["iterate"] = 1.5


@pytest.mark.parametrize("case", [
    "counters_and_gauges", "histogram_decimation", "records_per_sec",
    "no_throughput_without_phases"])
def test_registry_matches_jax(case):
    mine, ref = MetricsRegistry(), JaxRegistry()
    _fill_registry(mine, case)
    _fill_registry(ref, case)
    assert mine.summary() == ref.summary()
    assert mine.to_dict() == ref.to_dict()


def _drive_tracer(tr, case):
    if case == "nested":
        with tr.span("a", rows=3):
            with tr.span("b", x=np.int64(7)):
                pass
            with tr.span("c"):
                pass
    elif case == "instant_and_error":
        with tr.span("host"):  # the JAX Tracer.instant deadlocks on a
            tr.instant("mark", n=1)  # thread that never opened a span
        with pytest.raises(ValueError):
            with tr.span("bad", y=object.__name__):
                raise ValueError("no")
    elif case == "threads":
        # the workers run their spans one after another, and each stays
        # alive until all are done: a thread ident is reused once its
        # thread exits, so workers that exit in turn would map to a
        # varying number of tids from run to run
        release = threading.Event()

        def work(k, done):
            with tr.span("worker", k=k):
                with tr.span("inner"):
                    pass
            done.set()
            assert release.wait(timeout=30)

        threads = []
        with tr.span("driver"):
            for k in range(3):
                done = threading.Event()
                t = threading.Thread(target=work, args=(k, done))
                t.start()
                threads.append(t)
                assert done.wait(timeout=30)
        release.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    elif case == "close_open":
        outer = tr.span("outer")
        outer.__enter__()
        tr.span("inner").__enter__()
        assert tr.close_open_spans(error="E: x") == 2
        outer.__exit__(None, None, None)  # already exported: no duplicate


@pytest.mark.parametrize("case", ["nested", "instant_and_error", "threads",
                                  "close_open"])
def test_tracer_export_matches_jax(case):
    def clock_of():
        c = itertools.count()
        return lambda: next(c) * 1e-3

    mine, ref = Tracer(clock=clock_of()), JaxTracer(clock=clock_of())
    _drive_tracer(mine, case)
    _drive_tracer(ref, case)

    def body(tr):  # the process_name event names the package
        return [e for e in tr.chrome_trace() if e["name"] != "process_name"]

    assert body(mine) == body(ref)


def test_instant_on_a_fresh_thread_records_its_depth():
    tr = Tracer()
    tr.instant("first", n=1)
    with tr.span("s"):
        tr.instant("inside")
    ev = {e["name"]: e for e in tr._events}
    assert ev["first"]["depth"] == 0 and ev["inside"]["depth"] == 1


def test_tracer_spans_hold_under_concurrent_threads():
    """Eight threads open nested spans at a shortened switch interval: every
    span is recorded once, on its own thread, at its nesting depth."""
    tr = Tracer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        barrier = threading.Barrier(8)

        def work():
            barrier.wait(timeout=30)
            for _ in range(100):
                with tr.span("outer"):
                    with tr.span("inner"):
                        pass
            barrier.wait(timeout=30)  # all alive: eight distinct idents

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    ev = tr.chrome_trace()
    spans = [e for e in ev if e["ph"] == "X"]
    assert len(spans) == 8 * 100 * 2
    by_tid = {}
    for e in tr._events:
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == 8
    for events in by_tid.values():
        assert {(e["name"], e["depth"]) for e in events} == {
            ("outer", 0), ("inner", 1)}


def _fill_attrib(reg, case):
    if case == "wordcount_like":
        reg.set("attrib/pre_phase_ms", 12.5)
        reg.count("pipeline/feed_wait_ms", 40.0)
        for v in (3.0, 4.5, 10.0):
            reg.observe("feed_block_ms", v)
        reg.observe("device/compute_ms", 2.0)
        reg.phases.update({"split": 0.01, "write": 0.2, "map+reduce": 0.5})
    elif case == "kmeans_like":
        reg.count("attrib/init_ms", 30.0)
        reg.observe("device/compute_ms", 100.0)
        reg.phases.update({"iterate": 0.4, "write": 0.001})
    elif case == "over_attributed":
        reg.count("pipeline/feed_wait_ms", 5000.0)


@pytest.mark.parametrize("case", ["wordcount_like", "kmeans_like", "empty",
                                  "over_attributed"])
def test_attrib_compute_matches_jax(case):
    mine = types.SimpleNamespace(registry=MetricsRegistry(), heartbeat=None)
    ref = types.SimpleNamespace(registry=JaxRegistry(), heartbeat=None)
    _fill_attrib(mine.registry, case)
    _fill_attrib(ref.registry, case)
    got = attrib.compute(mine, elapsed_s=1.25)
    want = jax_attrib.compute(ref, programs={}, elapsed_s=1.25)
    assert got == want
    assert attrib.where_token(got) == jax_attrib.where_token(want)
    assert attrib.render(got) == jax_attrib.render(want)
    attrib.publish(mine, got)
    jax_attrib.publish(ref, want)
    assert mine.registry.summary() == ref.registry.summary()


def _keys_and_counts(seed, n=5000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, size=300, dtype=np.uint64)[
        rng.zipf(1.5, size=n) % 300]
    return keys, rng.integers(1, 5, size=n).astype(np.int32)


@pytest.mark.parametrize("case", ["mix64", "weighted_checksum",
                                  "hll_estimate", "audit"])
def test_dataplane_matches_jax(case):
    keys, vals = _keys_and_counts(3)
    if case == "mix64":
        np.testing.assert_array_equal(dataplane.mix64(keys),
                                      jax_dataplane.mix64(keys))
    elif case == "weighted_checksum":
        assert dataplane.weighted_checksum(keys, vals) == (
            jax_dataplane.weighted_checksum(keys, vals))
    elif case == "hll_estimate":
        for regs in (np.zeros(4096, np.int32),
                     np.random.default_rng(4).integers(0, 9, 4096)):
            assert dataplane.hll_estimate(regs) == jax_hll(regs)
    else:
        audits = (dataplane.DataPlaneAudit(1), jax_dataplane.DataPlaneAudit(1))
        uk, inv = np.unique(keys, return_inverse=True)
        out = np.bincount(inv, weights=vals).astype(np.int64)
        for a in audits:
            for lo in range(0, keys.shape[0], 1000):
                a.record_fold_in(keys[lo:lo + 1000], vals[lo:lo + 1000])
            a.set_records_in(int(vals.sum()))
            a.record_fold_out(uk, out)
            a.resolve_hot_keys({int(k): b"k%d" % i
                                for i, k in enumerate(uk[:5])}.__getitem__)
            a.check_fold()
            a.check_total(int(out.sum()))
        got, want = (a.doc() for a in audits)
        assert got == want and got["conservation"]["violations"] == []
        assert dataplane.render(got) == jax_dataplane.render(want)
        assert dataplane.ledger_section(got) == jax_dataplane.ledger_section(
            want)
        regs = [MetricsRegistry(), JaxRegistry()]
        for a, r in zip(audits, regs):
            a.publish(r)
        assert regs[0].summary() == regs[1].summary()
        with pytest.raises(dataplane.ConservationError):
            audits[0].check_total(int(out.sum()) + 1)


@pytest.mark.parametrize("n", [0, 999, 1024, 5 << 20, 3 << 30, 7 << 40,
                               "x"])
def test_format_bytes_matches_jax(n):
    assert format_bytes(n) == jax_format_bytes(n)


def test_heartbeat_lines_match_jax():
    def drive(cls):
        t = iter(np.arange(0.0, 100.0, 1.5))
        lines = []
        hb = cls(total_bytes=1000, interval_s=2.0, clock=lambda: next(t),
                 emit=lines.append)
        hb.set_phase("map+reduce")
        for i in range(10):
            hb.update(rows=100, bytes_done=100 * (i + 1))
        hb.update(fraction=0.5)
        hb.where = "compute 61%"
        hb.final_beat()
        return lines

    assert drive(Heartbeat) == drive(JaxHeartbeat)


def test_obs_records_no_spans_when_untraced(tmp_path):
    obs = Obs.from_config(JobConfig(backend="cpu"))
    assert obs.feed_span(rows=1) is obs.tracer.span("x")
    with obs.phase("split"):
        pass
    assert obs.tracer._events == []
    assert "attrib/pre_phase_ms" in obs.registry.gauges
    # the device map and the resident k-means, untraced: no span, but
    # every counter of their host steps and of the envelope
    corpus, pts = tmp_path / "c.txt", tmp_path / "p.npy"
    corpus.write_bytes(_corpus())
    np.save(pts, _points())
    steps = ("read", "stage", "enqueue", "fetch_wait", "dict")
    for workload, inp, kw, keys in (
            ("wordcount", corpus, JOBS["wordcount_device"][1],
             {f"device_map/{s}_ms" for s in steps}),
            ("kmeans", pts, JOBS["kmeans_device"][1],
             {"kmeans/read_points_ms", "kmeans/copy_points_ms"})):
        seen = []
        r = run_job(JobConfig(input_path=str(inp), backend="cpu",
                              output_path="", metrics=False, **kw),
                    workload, on_obs=seen.append)
        assert seen[0].tracer._events == [] and r.trace is None
        assert keys | {"obs/envelope_ms"} <= set(r.metrics)
        assert all(r.metrics[k] > 0 for k in keys | {"obs/envelope_ms"})


@pytest.mark.parametrize("case", ["wordcount_like", "kmeans_like", "empty",
                                  "over_attributed"])
def test_critpath_matches_jax(case):
    """The one-process critical path of the same attribution document:
    the same document, headline gauges and report as the JAX package's
    ``degenerate_from_attrib``, ``publish`` and ``render``."""
    from map_oxidize_tpu.obs import critpath as jax_critpath
    from map_oxidize_tpu_torch.obs import critpath

    reg = JaxRegistry()
    _fill_attrib(reg, case)
    doc = jax_attrib.compute(types.SimpleNamespace(registry=reg),
                             programs={}, elapsed_s=1.25)
    mine = critpath.degenerate_from_attrib(doc, process=0)
    theirs = jax_critpath.degenerate_from_attrib(doc, process=0)
    assert mine == theirs
    regs = MetricsRegistry(), JaxRegistry()
    assert critpath.publish(regs[0], mine) == jax_critpath.publish(
        regs[1], theirs)
    assert regs[0].summary() == regs[1].summary()
    assert critpath.render(mine) == jax_critpath.render(theirs)
