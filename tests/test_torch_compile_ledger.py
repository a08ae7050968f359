"""The port's launch ledger and program observatory against the JAX
package's (``obs/compile.py``, ``obs/xprof.py``): the recompile-cause
rules, the per-program compile and dispatch record of a word-count and a
k-means job from fresh ledgers (dispatches, compiles, shape sets,
logical chunks, causes), the sampling cadence (the 1st and every 16th
dispatch of a job), the flat report's keys, the stall detector, and the
costs every observed program declares."""

import types

import numpy as np
import pytest

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import compile as jax_compile
from map_oxidize_tpu.obs import xprof as jax_xprof
from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from map_oxidize_tpu.runtime import dispatch as jd
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs import compile as led
from map_oxidize_tpu_torch.obs import xprof
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.obs.trace import Tracer
from map_oxidize_tpu_torch.runtime import dispatch as td
from map_oxidize_tpu_torch.runtime import run_job

T = ("t", (8,), "int32")
SIGS = {
    "new_input_shape": ([T, ("v", "'sum'")],
                        [("t", (16,), "int32"), ("v", "'sum'")]),
    "new_dtype": ([T, ("v", "'sum'")], [("t", (8,), "float32"),
                                        ("v", "'sum'")]),
    "new_static_config": ([T, ("v", "'sum'")], [T, ("v", "'max'")]),
    "signature_change": ([T, ("v", "'sum'")],
                         [("t", (16,), "float32"), ("v", "'max'")]),
    "two_seen": ([T, ("v", "1")], [("t", (9,), "int32"), ("v", "2")]),
}


@pytest.mark.parametrize("case", list(SIGS))
def test_classify_matches_jax(case):
    old, new = (tuple(s) for s in SIGS[case])
    seen = {old: None, (("t", (3,), "int8"),): None}
    assert led._classify(new, seen) == jax_compile._classify(new, seen)
    if case != "two_seen":
        assert led._classify(new, seen) == case


def _fresh():
    import jax

    jax.clear_caches()
    jax_compile.LEDGER.programs.clear()
    led.LEDGER.reset()
    td._auto_cache.clear()
    jd._auto_cache.clear()


def _inputs(tmp_path):
    rng = np.random.default_rng(7)
    words = [b"w%d" % i for i in range(300)]
    z = rng.zipf(1.4, size=(2500, 10)) % 300
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"\n".join(b" ".join(words[j] for j in r)
                                  for r in z) + b"\n")
    pts = tmp_path / "p.npy"
    np.save(pts, rng.normal(0, 5, size=(3000, 4)).astype(np.float32))
    return str(corpus), str(pts)


JOBS = {
    "wordcount": ("wordcount", dict(chunk_bytes=8192, batch_size=2048,
                                    initial_key_capacity=64)),
    "wordcount_batched": ("wordcount", dict(chunk_bytes=8192,
                                            batch_size=512,
                                            dispatch_batch=3)),
    "wordcount_device": ("wordcount", dict(mapper="device",
                                           chunk_bytes=8192,
                                           device_chunk_keys=2048)),
    "kmeans_device": ("kmeans", dict(mapper="device", kmeans_k=4,
                                     kmeans_iters=3)),
    "kmeans_stream_device": ("kmeans", dict(kmeans_k=4, kmeans_iters=3,
                                            chunk_bytes=2048,
                                            kmeans_device_fit_bytes=64,
                                            dispatch_batch=3)),
    "kmeans_stream": ("kmeans", dict(mapper="native", kmeans_k=4,
                                     kmeans_iters=2, chunk_bytes=4096)),
}
#: the record of each program that must match the JAX package's exactly
FIELDS = ("compiles", "dispatches", "shape_sets", "logical_chunks",
          "recompile_causes")


@pytest.mark.parametrize("job", list(JOBS))
def test_program_record_matches_jax(tmp_path, job):
    """The same job twice in each package from fresh ledgers (the second
    run finds every program warm): per program the same dispatches,
    compiles, shape sets, logical chunks and recompile causes."""
    corpus, pts = _inputs(tmp_path)
    workload, kw = JOBS[job]
    inp = pts if workload == "kmeans" else corpus
    common = dict(input_path=inp, backend="cpu", metrics=False,
                  output_path="", **kw)
    _fresh()
    reports = {}
    for pkg, cfg, run in (("port", JobConfig(**common), run_job),
                          ("jax", JaxJobConfig(num_shards=1, **common),
                           jax_run_job)):
        rows = []
        for _ in range(2):
            cfg.metrics_out = str(tmp_path / f"{pkg}.json")
            run(cfg, workload)
            import json

            doc = json.loads((tmp_path / f"{pkg}.json").read_text())
            rows.append({name: {f: r[f] for f in FIELDS}
                         for name, r in doc["xprof"]["programs"].items()})
        reports[pkg] = rows
    assert reports["port"] == reports["jax"]
    cold, warm = reports["port"]
    assert cold and all(r["compiles"] >= 1 for r in cold.values())
    assert all(r["compiles"] == 0 for r in warm.values())
    if job == "kmeans_stream_device":
        step = cold["kmeans/stream_step"]
        assert step["compiles"] == 3 and step["recompile_causes"] == [
            "new_static_config"] * 2


def test_samples_on_the_first_and_every_16th_dispatch():
    """40 dispatches of one program in a job: samples at dispatch 1, 16
    and 32, in both packages; only the non-compiling ones land in the
    dispatch gap."""
    import jax
    import jax.numpy as jnp
    import torch

    _fresh()
    mine = led.observed("test/add", lambda x: x + 1)
    theirs = jax_compile.observed_jit("test/add",
                                      jax.jit(lambda x: x + 1))
    obs = Obs.from_config(JobConfig(backend="cpu"))
    jobs = types.SimpleNamespace(registry=JaxRegistry(), heartbeat=None,
                                 current_phase=None)
    jbase = jax_compile.LEDGER.activate(jobs)
    x, jx = torch.zeros(4), jnp.zeros(4)
    for _ in range(40):
        mine(x)
        theirs(jx)
    rep = obs.finish_xprof()
    jrep = jax_xprof.job_report(jax_compile.LEDGER.job_delta(
        jbase, jax_compile.LEDGER.deactivate(jobs)))
    row, jrow = rep["programs"]["test/add"], jrep["programs"]["test/add"]
    for f in ("dispatches", "compiles", "device_samples", "logical_chunks"):
        assert row[f] == jrow[f]
    assert row["device_samples"] == 3 and row["logical_chunks"] == 39
    gaps = obs.registry.histograms["device/dispatch_gap_ms"]
    assert gaps.count == jobs.registry.histograms[
        "device/dispatch_gap_ms"].count == 39


DELTA = {
    "engine/merge": {
        "compiles": 1, "compile_ms": 12.5, "backend_compile_ms": 0.0,
        "dispatches": 9, "dispatch_ms": 4.0, "sampled_device_ms": 3.0,
        "device_samples": 2, "logical_chunks": 8,
        "recompile_causes": ["new_input_shape"], "shape_sets": 2,
        "flops_per_dispatch": 5e6, "bytes_per_dispatch": 1e6},
    "engine/grow_concat": {
        "compiles": 1, "compile_ms": 1.0, "backend_compile_ms": 0.0,
        "dispatches": 1, "dispatch_ms": 0.0, "sampled_device_ms": 0.2,
        "device_samples": 1, "logical_chunks": 0, "recompile_causes": [],
        "shape_sets": 1, "flops_per_dispatch": None,
        "bytes_per_dispatch": 4e4},
    "kmeans/stream_step": {
        "compiles": 3, "compile_ms": 30.0, "backend_compile_ms": 0.0,
        "dispatches": 108, "dispatch_ms": 50.0, "sampled_device_ms": 0.0,
        "device_samples": 0, "logical_chunks": 210,
        "recompile_causes": ["new_static_config"] * 2, "shape_sets": 3,
        "flops_per_dispatch": 4e5, "bytes_per_dispatch": 7e4},
}


@pytest.mark.parametrize("peak", [None, "1e12"])
def test_flatten_report_matches_jax(peak, monkeypatch):
    """The same ledger delta through both reports: the same flat keys,
    and the same values but for the memory/compute class (the machine
    balance of the fallback differs: the port's is its card's)."""
    if peak:
        monkeypatch.setenv("MOXT_PEAK_FLOPS", peak)
        monkeypatch.setenv("MOXT_PEAK_MEMBW", "1e10")
    mine = xprof.flatten_report(xprof.job_report(DELTA))
    theirs = jax_xprof.flatten_report(jax_xprof.job_report(DELTA))
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if not k.endswith("/bound")} == {
        k: v for k, v in theirs.items() if not k.endswith("/bound")}
    assert ("xprof/engine/merge/mfu_pct" in mine) == bool(peak)
    assert "xprof/engine/grow_concat/bound" not in mine
    if peak:
        assert mine == theirs
    rep = xprof.job_report(DELTA)
    assert xprof.render_report(rep).count("\n") == jax_xprof.render_report(
        jax_xprof.job_report(DELTA)).count("\n")


def test_stall_detector_matches_jax():
    """A fake clock: chunks every second, then none for 10 s; both
    detectors warn once at the same tick and count ``heartbeat/stalls``."""
    regs = MetricsRegistry(), JaxRegistry()
    obs = [types.SimpleNamespace(registry=r, heartbeat=None,
                                 tracer=Tracer()) for r in regs]
    samplers = (xprof.DeviceSampler(obs[0], stall_factor=3.0),
                jax_xprof.DeviceSampler(obs[1], stall_factor=3.0))
    fired = [[], []]
    for t in range(20):
        for i, (r, s) in enumerate(zip(regs, samplers)):
            if t < 8:
                r.count("engine/flushes")
            fired[i].append(s.check_stall(now=float(t)))
    assert fired[0] == fired[1] and sum(fired[0]) == 1
    assert regs[0].counters["heartbeat/stalls"] == 1


def test_every_program_declares_a_cost():
    """The programs the JAX package observes, on one device and on the
    mesh, each have a cost row; all but the copies and fills
    (``engine/grow_concat``, ``shuffle/grow``, ``shuffle/init_acc``,
    ``collect/grow``) count FLOPs."""
    import torch

    from map_oxidize_tpu_torch.parallel.mesh import make_mesh

    a = torch.zeros(64, dtype=torch.int64)
    v = torch.zeros(64, dtype=torch.int32)
    m = make_mesh(2, "cpu")
    a2, v2 = [a, a], [v, v]
    sharded = {
        "shuffle/merge": ((m, a2, v2, [a[0]] * 2, a2, v2),
                          {"cap": 8, "combine": "sum"}),
        "shuffle/top_k": ((m, a2, v2), {"k_local": 8, "k_final": 16}),
        "shuffle/grow": ((m, a2, v2, 16, "sum"), {}),
        "shuffle/init_acc": ((m, 64, (), "int32", "sum"), {}),
        "collect/route_append": ((m, a2, a2, [a[0]] * 2, a2, a2),
                                 {"cap": 8, "splitters": None,
                                  "method": "all_to_all"}),
        "collect/grow": ((m, a2, a2, 16), {}),
        "collect/sort_sharded": ((m, a2, a2), {}),
        "kmeans/fit_sharded": ((m, [torch.zeros(50, 3)] * 2,
                                [torch.zeros(4, 3)] * 2, 4, 5), {}),
        "device_map/tokenize_group": (
            ([torch.zeros(256, dtype=torch.uint8)] * 2,),
            {"max_tokens": 129, "out_keys": 128, "fetch_keys": 16}),
    }
    args = {
        "engine/merge": (a, v, a[0], a[:16], v[:16]),
        "engine/merge_packed": (a, v, a[0], torch.zeros((3, 16),
                                                        dtype=torch.int32)),
        "engine/merge_packed_batch": (a, v, a[0], torch.zeros(
            (2, 3, 16), dtype=torch.int32)),
        "engine/pack_finalize": (a, v, a[0], a[0]),
        "engine/grow_concat": (a, v, a, v),
        "engine/top_k": (a, v, 8),
        "collect/sort": (torch.zeros((4, 32), dtype=torch.int32),),
        "device_map/tokenize": (torch.zeros(256, dtype=torch.uint8), 129,
                                128, 16),
        "device_map/prefix_pack": (v, v, v, 8),
        "kmeans/step": (torch.zeros(4, 3), torch.zeros(100, 3), 4),
        "kmeans/fit": (torch.zeros(4, 3), torch.zeros(100, 3), 4, 5),
        "kmeans/stream_step": (torch.zeros(100, 3), torch.zeros(4, 3),
                               torch.zeros(4, 4), 50),
    }
    assert set(args) | set(sharded) == set(led.COSTS)
    copies = {"engine/grow_concat", "shuffle/grow", "shuffle/init_acc",
              "collect/grow"}
    calls = {name: (a_, {}) for name, a_ in args.items()}
    calls.update(sharded)
    # the sharded stream step shares its name with the one-device step
    calls["kmeans/stream_step (sharded)"] = (
        (m, [torch.zeros(50, 3)] * 2, [torch.zeros(4, 3)] * 2,
         torch.zeros(4, 4), 25), {})
    for name, (a_, kw) in calls.items():
        flops, nbytes = led._cost_of(name.split(" ")[0], a_, kw)
        assert nbytes > 0, name
        assert (flops is None) == (name in copies), name
