"""The port's multi-process observability on the CPU: trace shards, the
merge, the skew report, the per-process metrics documents, the ledger
entry, prefixed progress lines, and the critical path's shard half.

One 2-process port word count with every obs flag on serves the artifact
asserts (JAX ``tests/test_obs_distributed.py`` :116-217); one JAX
2-process run of the same job (the JAX package's own child) gives the
reference key sets, which the port's must equal with an empty allowlist.
A second port run with process 1 slowed is the real straggler (JAX
``tests/test_critpath.py`` :530-582).  On the JAX package's synthetic
shards (exact timings) the port's critical-path document equals the JAX
package's (:81-:368), and two processes probing into two stores write
identical rows (``tests/test_calib_probe.py:399``).
"""

import json
import os
import subprocess
import sys

import pytest

import test_torch_distributed as td

WC = dict(output_path="", chunk_bytes=4096, batch_size=1 << 12,
          key_capacity=1 << 12, top_k=5, num_shards=8)


def _obs_cfg(tmp, corpus, **kw):
    return dict(WC, input_path=str(corpus), trace_out=f"{tmp}/t.json",
                metrics_out=f"{tmp}/m.json", ledger_dir=f"{tmp}/ledger",
                **kw)


@pytest.fixture(scope="module")
def dist_obs_run(tmp_path_factory):
    """One port 2-process word count with every obs flag on; returns
    (artifact dir, payloads, per-process logs, corpus path)."""
    tmp = tmp_path_factory.mktemp("port_dist_obs")
    corpus = td.write_corpus(tmp / "c.txt")
    payloads, logs = td.launch(
        tmp, "wordcount", _obs_cfg(tmp, corpus, progress=True,
                                   progress_interval_s=0.001),
        log_info=True)
    return tmp, payloads, logs, corpus


@pytest.fixture(scope="module")
def jax_dist_obs_run(tmp_path_factory):
    """The JAX package's 2-process run of the same job (its own child
    from ``tests/test_obs_distributed.py``): the reference documents."""
    import test_obs_distributed as jod

    tmp = tmp_path_factory.mktemp("jax_dist_obs")
    corpus = td.write_corpus(tmp / "c.txt")
    td.run_children(
        lambda port: [[sys.executable, "-c", jod._CHILD, str(i), "2",
                       str(port), corpus, str(tmp)] for i in range(2)],
        env=jod._env())
    return tmp


def _records(corpus) -> int:
    from map_oxidize_tpu_torch.workloads.reference_model import (
        wordcount_model,
    )

    with open(corpus, "rb") as f:
        return sum(wordcount_model([f.read()]).values())


def test_shard_schema_and_stamp(dist_obs_run):
    tmp, _p, _logs, _corpus = dist_obs_run
    from map_oxidize_tpu.obs.merge import SHARD_SCHEMA, read_shard

    shards = [read_shard(str(tmp / f"t.json.proc{p}")) for p in (0, 1)]
    hashes = set()
    for p, s in enumerate(shards):
        assert s["schema"] == SHARD_SCHEMA
        assert s["meta"]["process"] == p
        assert s["meta"]["n_processes"] == 2
        assert s["meta"]["workload"] == "wordcount"
        assert s["meta"]["wall_start_unix_s"] > 0
        hashes.add(s["meta"]["config_hash"])
        assert isinstance(s["events"], list) and s["events"]
        assert {"phases_s", "counters", "gauges",
                "histograms"} <= set(s["metrics"])
    assert len(hashes) == 1   # one job: the dist_* fields are not identity


def test_merged_trace_pid_tid_mapping(dist_obs_run):
    tmp, _p, _logs, _corpus = dist_obs_run
    merged = json.loads((tmp / "t.json").read_text())
    xs = [e for e in merged if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0, 1}
    for e in merged:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "X":
            assert isinstance(e["tid"], int)
            assert e["dur"] >= 0 and e["ts"] >= 0
    names = {e["name"] for e in xs}
    assert {"dist/map_chunk", "dist/lockstep_flag", "dist/merge_local",
            "phase/map+reduce"} <= names
    proc_names = {e["pid"]: e["args"]["name"] for e in merged
                  if e.get("name") == "process_name"}
    assert proc_names == {0: "proc 0", 1: "proc 1"}


def test_skew_report_rows_sum_to_oracle(dist_obs_run):
    tmp, _p, _logs, corpus = dist_obs_run
    skew = json.loads((tmp / "t.json.skew.json").read_text())
    assert skew["n_processes"] == 2
    per_proc = {r["process"]: r for r in skew["processes"]}
    assert set(per_proc) == {0, 1}
    assert skew["records_total"] == _records(corpus)
    assert (per_proc[0]["records_in"] + per_proc[1]["records_in"]
            == skew["records_total"])
    assert per_proc[0]["flag_rounds"] == per_proc[1]["flag_rounds"] >= 1
    assert skew["rows_fed_total"] == sum(
        r["rows_fed"] for r in skew["processes"])
    assert len(skew["straggler_ranking"]) == 2
    assert skew["coverage"]["missing_processes"] == []
    assert skew["critpath"]["n_processes"] == 2


def test_per_process_metrics_documents(dist_obs_run):
    tmp, payloads, _logs, _corpus = dist_obs_run
    total = 0
    for p in (0, 1):
        md = json.loads((tmp / f"m.json.proc{p}").read_text())
        assert md["meta"]["process"] == p
        assert md["gauges"]["records_in"] == payloads[p]["records"]
        assert md["gauges"]["flag_rounds"] >= 1
        assert md["counters"]["shuffle/all_to_all_bytes"] > 0
        total += md["gauges"]["records_in"]
    assert total == sum(p["records"] for p in payloads)
    # process 0's document gained the merged critical path
    md0 = json.loads((tmp / "m.json.proc0").read_text())
    assert md0["critpath"]["n_processes"] == 2


def test_ledger_entry_from_process_zero(dist_obs_run):
    tmp, _p, _logs, corpus = dist_obs_run
    from map_oxidize_tpu.obs import ledger

    entries = ledger.read(str(tmp / "ledger"))
    assert len(entries) == 1   # process 0 only
    e = entries[0]
    assert e["workload"] == "wordcount" and e["n_processes"] == 2
    assert e["records_total"] == _records(corpus)
    assert "map+reduce" in e["phases_s"]
    assert e["config_hash"] and e["version"]
    assert "comms" in e and "critpath" in e


def test_heartbeat_prefixed_and_process_zero_only(dist_obs_run):
    _tmp, _p, logs, _corpus = dist_obs_run
    assert "[proc 0] progress: phase=map+reduce" in logs[0]
    assert "progress:" not in logs[1]


def test_metric_keys_equal_the_jax_package_s(dist_obs_run,
                                             jax_dist_obs_run):
    """The P-process documents carry the JAX package's keys and sections
    exactly: no allowlist, no key of the port's own (the Gloo wire is
    named in the logs, not in a key)."""
    tmp, _p, _logs, _corpus = dist_obs_run
    jtmp = jax_dist_obs_run
    for p in (0, 1):
        mine = json.loads((tmp / f"m.json.proc{p}").read_text())
        ref = json.loads((jtmp / f"m.json.proc{p}").read_text())
        assert set(mine) == set(ref)
        assert set(mine["meta"]) == set(ref["meta"])
        assert list(mine["attrib"]["buckets"]) == list(
            ref["attrib"]["buckets"])
        for sec in ("counters", "gauges", "histograms"):
            assert set(mine[sec]) == set(ref[sec]), sec
        assert set(mine["phases_s"]) == set(ref["phases_s"])
        s_mine = json.loads((tmp / f"t.json.proc{p}").read_text())
        s_ref = json.loads((jtmp / f"t.json.proc{p}").read_text())
        assert set(s_mine) == set(s_ref)
        assert ({e["name"] for e in s_mine["events"]}
                == {e["name"] for e in s_ref["events"]})
    skew = json.loads((tmp / "t.json.skew.json").read_text())
    jskew = json.loads((jtmp / "t.json.skew.json").read_text())
    assert set(skew) == set(jskew)
    assert set(skew["critpath"]) == set(jskew["critpath"])
    e = json.loads((tmp / "ledger" / "ledger.jsonl").read_text())
    je = json.loads((jtmp / "ledger" / "ledger.jsonl").read_text())
    assert set(e) == set(je)
    assert set(e["metrics"]) == set(je["metrics"])


def test_obs_merge_cli_re_merges_real_shards(dist_obs_run, tmp_path):
    """``obs merge`` over the port's shards: the port's and the JAX
    package's CLIs print the same report and write the same trace."""
    import contextlib
    import io

    from map_oxidize_tpu.cli import main as jax_main
    from map_oxidize_tpu_torch.cli import main as port_main

    tmp, _p, _logs, _corpus = dist_obs_run
    got = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = tmp_path / f"{name}.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["obs", "merge", str(tmp / "t.json"), "--out",
                       str(out)])
        assert rc == 0
        got[name] = (buf.getvalue().replace(str(out), "OUT"),
                     json.loads(out.read_text()))
    assert got["port"] == got["jax"]
    assert "merged 2 shards" in got["port"][0]
    assert {e["pid"] for e in got["port"][1] if e["ph"] == "X"} == {0, 1}


# --- the critical path's shard half ------------------------------------------


@pytest.fixture(scope="module")
def straggler_run(tmp_path_factory):
    """One port 2-process word count with process 1 sleeping per chunk
    and the live plane sampling; returns (artifact dir, payloads)."""
    tmp = tmp_path_factory.mktemp("port_critpath")
    corpus = td.write_corpus(tmp / "c.txt")
    payloads = td.launch(tmp, "wordcount",
                         _obs_cfg(tmp, corpus, obs_sample_s=0.2),
                         slow_map_s=0.3)
    return tmp, payloads


def test_real_straggler_blame_slack_and_whatif(straggler_run):
    from map_oxidize_tpu_torch.obs import critpath

    tmp, payloads = straggler_run
    cp = json.loads((tmp / "t.json.skew.json").read_text())["critpath"]
    slept_ms = payloads[1]["slept_s"] * 1e3
    assert slept_ms > 0
    assert cp["blame"]["1"]["share_pct"] >= (
        100.0 * slept_ms / cp["wall_ms"]) * 0.9
    assert cp["blame"]["1"]["share_pct"] > cp["blame"]["0"]["share_pct"]
    assert abs(sum(r["share_pct"] for r in cp["blame"].values())
               - 100.0) < 0.5
    assert cp["slack"]["0"]["slack_ms"] > 0
    assert cp["path_over_wall_pct"] >= 90.0
    est = next(w for w in cp["what_if"]
               if w["name"] == critpath.WHATIF_PROC_MEDIAN.format(p=1))
    assert 0.5 * slept_ms <= est["est_delta_ms"] <= 1.6 * slept_ms


def test_real_run_ledger_and_metrics_doc_carry_critpath(straggler_run):
    from map_oxidize_tpu_torch.obs import ledger

    tmp, _payloads = straggler_run
    (e,) = ledger.read(str(tmp / "ledger"))
    for key in ("critpath/bound_frac", "critpath/top_blame_share",
                "critpath/top_process_slack_ms",
                "critpath/collective_wait_share_pct",
                "critpath/path_over_wall_pct", "critpath/bound_by"):
        assert key in e["metrics"], key
    assert e["metrics"]["critpath/top_blame_share"] > 0.5
    assert e["metrics"]["critpath/straggler_save_frac"] > 0.3
    assert e["metrics"].get("alerts/fired", 0) >= 1
    assert e["critpath"]["blame"]["1"]["share_pct"] > 50
    md = json.loads((tmp / "m.json.proc0").read_text())
    assert md["critpath"]["blame"]["1"]["share_pct"] > 50
    assert md["gauges"]["critpath/top_blame_share"] > 0.5


def test_real_run_cli_renders_from_trace_base(straggler_run):
    tmp, _payloads = straggler_run
    out = subprocess.run(
        [sys.executable, "-m", "map_oxidize_tpu_torch", "obs", "critpath",
         str(tmp / "t.json")], capture_output=True, text=True,
        env=td.port_env(), cwd=td.REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "bound by: proc 1" in out.stdout
    assert "slack" in out.stdout and "what-if" in out.stdout


def _synthetic():
    """The JAX package's synthetic shard sets (exact timings)."""
    import test_critpath as jc

    overlap = []
    for p in (0, 1):
        ev, t = [], 0.0
        for r in range(2):
            ev.append(jc._X("dist/map_chunk", t, 100e3))
            ev.append(jc._X("dist/lockstep_flag", t + 100e3, 5e3, round=r))
            ev.append(jc._X("dist/merge_local", t + 105e3, 80e3, round=r))
            t += 185e3
        overlap.append(jc._shard(p, 1000.0, ev))
    return {
        "straggler": jc._straggler_shards(),
        "clean": jc._straggler_shards(slow_ms=100.0),
        "overlap": overlap,
        "four_rounds": jc._straggler_shards(slow_ms=250.0, rounds=4),
    }


@pytest.mark.parametrize("case", ["straggler", "clean", "overlap",
                                  "four_rounds"])
def test_critpath_document_equals_the_jax_package_s(case):
    """On the same shards both packages compute the same document, render
    the same report and publish the same headline gauges."""
    from map_oxidize_tpu.obs import critpath as jax_cp
    from map_oxidize_tpu_torch.obs import critpath

    shards = _synthetic()[case]
    doc = critpath.compute_from_shards(json.loads(json.dumps(shards)))
    ref = jax_cp.compute_from_shards(json.loads(json.dumps(shards)))
    assert doc == ref
    assert critpath.render(doc) == jax_cp.render(ref)
    assert critpath.headline(doc) == jax_cp.headline(ref)
    if case == "straggler":
        assert doc["blame"]["1"]["share_pct"] > 90.0
        assert doc["slack"]["0"]["slack_ms"] == pytest.approx(600.0,
                                                              rel=0.05)
        assert doc["dag"]["edges"]["barrier"] == 3 * 2 * 2
    events, _skew = jax_cp_merge(shards)
    assert critpath.compute_from_merged_events(events) == (
        jax_cp.compute_from_merged_events(events))


def jax_cp_merge(shards):
    from map_oxidize_tpu.obs import merge as jax_merge
    from map_oxidize_tpu_torch.obs import merge

    got = merge.merge_shards(json.loads(json.dumps(shards)))
    ref = jax_merge.merge_shards(json.loads(json.dumps(shards)))
    assert got == ref
    return got


def test_refusals_and_postmortem_match_the_jax_package(tmp_path):
    """Clock skew, mixed identity, duplicate slots and an unanchorable
    shard refuse with the JAX package's named errors; a torn shard
    yields a post-mortem merge with a named coverage gap; traces without
    round tags merge with a named critpath note."""
    import test_critpath as jc

    from map_oxidize_tpu_torch.obs import critpath
    from map_oxidize_tpu_torch.obs import merge

    skewed = jc._straggler_shards()
    skewed[1]["meta"]["wall_start_unix_s"] = 1030.0
    with pytest.raises(critpath.ClockSkewError, match="wall-clock skew"):
        critpath.compute_from_shards(skewed)
    with pytest.raises(critpath.ClockSkewError):
        merge.merge_shards(skewed)
    assert merge.merge_shards(skewed, allow_clock_skew=True)[0]
    mixed = jc._straggler_shards()
    mixed[1]["meta"]["config_hash"] = "other"
    with pytest.raises(ValueError, match="not shards of one job"):
        critpath.compute_from_shards(mixed)
    dup = jc._straggler_shards()
    dup[1]["meta"]["process"] = 0
    with pytest.raises(ValueError, match="duplicate process slots"):
        critpath.compute_from_shards(dup)
    bare = jc._straggler_shards()
    del bare[0]["meta"]["wall_start_unix_s"]
    with pytest.raises(ValueError, match="wall_start_unix_s"):
        critpath.compute_from_shards(bare)

    base = str(tmp_path / "t.json")
    attrib = {"wall_ms": 1000.0, "unattributed_pct": 10.0,
              "buckets": {"host_produce": {"ms": 700.0},
                          "device_compute": {"ms": 200.0}}}
    with open(base + ".proc0", "w") as f:
        json.dump(jc._shard(0, 1000.0, jc._lockstep_events(100.0),
                            attrib=attrib), f)
    with open(base + ".proc1", "w") as f:
        f.write('{"schema": "moxt-obs-shard-v1", "meta": {"proc')  # torn
    skew = merge.merge_to_files(merge.find_shards(base), base)
    assert skew["coverage"]["missing_processes"] == [1]
    assert skew["coverage"]["torn_shards"] == ["t.json.proc1"]
    assert skew["critpath"].get("degenerate") == "attrib-timeline"

    base2 = str(tmp_path / "n.json")
    for p in (0, 1):
        ev = [jc._X("dist/map_chunk", 0.0, 50e3),
              jc._X("dist/lockstep_flag", 50e3, 5e3)]   # no round tag
        with open(base2 + f".proc{p}", "w") as f:
            json.dump(jc._shard(p, 1000.0, ev), f)
    skew = merge.merge_to_files(merge.find_shards(base2), base2)
    assert "no common lockstep rounds" in skew["critpath"]["error"]


_PROBE_SCRIPT = r"""
from map_oxidize_tpu_torch.obs.probe import run_probe
s = run_probe(spec["dirs"][pid], num_shards=8, backend="cpu",
              buckets=("16KB", "64KB"), reps=2)
print("probe child", pid, "merged", s["rows_merged"])
"""


def test_probe_two_process_gloo_identical_stores(tmp_path):
    """Under a process group the probe sweeps the global 8-slot mesh in
    lockstep: two processes probing into two stores write identical rows
    (shapes, payloads, counts; the walls are measurements), under the
    2-process identity."""
    from map_oxidize_tpu_torch.obs import calib

    dirs = [str(tmp_path / f"p{i}") for i in range(2)]
    logs = td.launch(tmp_path, "wordcount", dict(num_shards=8,
                                                 input_path=""),
                     script=_PROBE_SCRIPT, dirs=dirs, tag="probe")
    stores = [calib.CalibStore.load(os.path.join(d, calib.CALIB_FILE))
              for d in dirs]
    keys = [sorted(s.doc["comms"]) for s in stores]
    assert keys[0] == keys[1] and keys[0], logs
    for key in keys[0]:
        a, b = stores[0].doc["comms"][key], stores[1].doc["comms"][key]
        for fld in ("calls", "bytes", "latency_samples", "runs", "source",
                    "collective", "program", "shape_bucket", "topology",
                    "device_count"):
            assert a[fld] == b[fld], (key, fld)
        assert a["source"] == "probe"
    row = stores[0].doc["comms"][keys[0][0]]
    assert row["topology"] == "2x1"
