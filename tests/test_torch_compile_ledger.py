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


class _FakeEvent:
    """A CUDA event's surface the ledger uses, on a fake clock (ms)."""

    def __init__(self, t: float, waits: list):
        self.t, self.done, self.waits = t, False, waits

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waits.append(self.t)
        self.done = True

    def elapsed_time(self, end) -> float:
        return end.t - self.t


class _CardTensor:
    """What the ledger reads of a tensor on the card."""

    device = types.SimpleNamespace(type="cuda")
    shape, dtype = (4,), "float32"

    def element_size(self) -> int:
        return 4


def test_a_card_sample_is_an_event_pair_resolved_without_a_wait(
        monkeypatch):
    """On the card a sampled dispatch records an event before and after
    the call; the pair resolves at a later dispatch once its end event has
    completed, or at the job's ``finish_xprof``, and no dispatch waits.
    A compile's sample is its pair less the call's wall (the host's
    build is in the pair), and ``device/compute_ms`` gets nothing."""
    _fresh()
    waits, made = [], []

    def event(stream):
        i = len(made)  # pair i // 2: start at 10 (i // 2), end 2.5 later
        made.append(_FakeEvent(10.0 * (i // 2) + 2.5 * (i % 2), waits))
        return made[-1]

    monkeypatch.setattr(led, "_sample_stream", lambda args: "stream")
    monkeypatch.setattr(led, "_timing_event", event)
    prog = led.observed("test/card", lambda x: _CardTensor())
    obs = Obs.from_config(JobConfig(backend="cpu"))
    for i in range(40):
        prog(_CardTensor())
        if i == 15:  # the 16th dispatch's kernel ends before the 17th
            assert len(made) == 4 and not waits
            made[3].done = True
    assert len(made) == 6 and not waits
    stats = led.LEDGER.programs["test/card"]
    assert stats.samples == 1 and stats.sampled_ms == 2.5
    rep = obs.finish_xprof()
    # the finish waits for the job's pairs still pending: the compile's
    # and the last one
    assert waits == [made[1].t, made[5].t]
    row = rep["programs"]["test/card"]
    assert row["device_samples"] == 3
    assert 6.5 < row["sampled_device_ms"] <= 7.5
    assert row["device_time_source"] == "sampled_device_time"
    assert "device/compute_ms" not in obs.registry.histograms
    assert obs.registry.histograms["device/dispatch_gap_ms"].count == 39


def test_kmeans_costs_are_what_the_kernel_needs():
    """2 n k d + n d per assign + sum (the scores, then the sums), times
    the iterations of a fit, summed over the shards of a sharded one."""
    import torch

    from map_oxidize_tpu_torch.parallel.mesh import make_mesh

    n, k, d = 100, 8, 5
    one = 2 * n * k * d + n * d
    c, p = torch.zeros(k, d), torch.zeros(n, d)
    half = [torch.zeros(n // 2, d)] * 2
    m = make_mesh(2, "cpu")
    assert led._cost_of("kmeans/step", (c, p, k), {})[0] == one
    assert led._cost_of("kmeans/fit", (c, p, k, 3), {})[0] == 3 * one
    assert led._cost_of("kmeans/stream_step",
                        (p, c, torch.zeros(k, d + 1), 50), {})[0] == one
    assert led._cost_of("kmeans/fit_sharded",
                        (m, half, [c] * 2, k, 3), {})[0] == 3 * one
    assert led._cost_of("kmeans/stream_step",
                        (m, half, [c] * 2, torch.zeros(k, d + 1), 25),
                        {})[0] == one


def test_a_kmeans_job_s_row_carries_its_precision_and_cost(tmp_path):
    _corpus, pts = _inputs(tmp_path)
    _fresh()
    for precision in ("highest", "bf16"):
        r = run_job(JobConfig(input_path=pts, backend="cpu", mapper="device",
                              kmeans_k=4, kmeans_iters=3, output_path="",
                              metrics=False, kmeans_precision=precision,
                              metrics_out=str(tmp_path / "m.json")),
                    "kmeans")
        import json

        row = json.loads((tmp_path / "m.json").read_text())["xprof"][
            "programs"]["kmeans/fit"]
        assert row["precision"] == precision
        assert row["flops_per_dispatch"] == 3 * (2 * 3000 * 4 * 4
                                                 + 3000 * 4)
        assert r.metrics["xprof/kmeans/fit/dispatches"] == 1
    assert led._precision_of("engine/merge", (), {}) is None
    assert led._precision_of("kmeans/step", (None, None, 4), {}) == "highest"


def test_mfu_is_quoted_against_the_published_peak_of_the_precision(
        monkeypatch):
    """On an H100 (a fake loaded torch naming it): the published peaks,
    a ``highest`` program against the float32 rate and a ``bf16`` one
    against the bf16 rate; the bound class at each precision's balance."""
    card = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True, current_device=lambda: 0,
        get_device_name=lambda i: "NVIDIA H100 80GB HBM3"))
    monkeypatch.setattr(xprof, "loaded_torch", lambda: card)
    monkeypatch.delenv("MOXT_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MOXT_PEAK_MEMBW", raising=False)
    peaks = xprof.device_peaks()
    assert peaks == {"flops": 67e12, "flops_bf16": 989e12,
                     "membw": 3.35e12, "source": "published"}
    row = dict(DELTA["engine/merge"], sampled_device_ms=1.0,
               device_samples=1, dispatches=1, flops_per_dispatch=6.7e9,
               bytes_per_dispatch=1e8)
    rep = xprof.job_report({
        "kmeans/fit": dict(row, precision="highest"),
        "kmeans/step": dict(row, precision="bf16"),
        "engine/merge": dict(row)})
    progs = rep["programs"]
    assert progs["kmeans/fit"]["mfu_pct"] == 10.0
    assert progs["engine/merge"]["mfu_pct"] == 10.0
    assert progs["kmeans/step"]["mfu_pct"] == round(100 * 6.7e12 / 989e12,
                                                    3)
    # intensity 67 FLOP/B: above the float32 balance (20), below bf16's
    assert progs["kmeans/fit"]["bound"] == "compute"
    assert progs["kmeans/step"]["bound"] == "memory"
    monkeypatch.setenv("MOXT_PEAK_FLOPS", "1e12")
    assert xprof.peak_flops(xprof.device_peaks(), "bf16") == 1e12


def _fake_card(name: str):
    """A loaded torch whose initialised card is ``name``."""
    return types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True, current_device=lambda: 0,
        get_device_name=lambda i: name))


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
def test_other_h100_cards_have_no_published_peaks(name, monkeypatch):
    """The published figures are the SXM card's: an H100 of another form
    factor has lower rates, so it gets no peaks (and no MFU) until a row
    of its own is added."""
    monkeypatch.setattr(xprof, "loaded_torch", lambda: _fake_card(name))
    monkeypatch.delenv("MOXT_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MOXT_PEAK_MEMBW", raising=False)
    assert xprof.device_peaks() == {"flops": None, "flops_bf16": None,
                                    "membw": None, "source": "none"}


@pytest.mark.parametrize("precision,peak", [("highest", 67e12),
                                            ("bf16", 989e12)])
def test_the_resolver_estimates_compute_at_the_fits_precision(
        precision, peak, monkeypatch):
    """A cold auto-B resolution on an H100 takes the kernel's operations
    per chunk over the published peak of the fit's precision."""
    _fresh()
    monkeypatch.setattr(xprof, "loaded_torch",
                        lambda: _fake_card("NVIDIA H100 80GB HBM3"))
    monkeypatch.delenv("MOXT_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MOXT_DISPATCH_FLOOR_MS", raising=False)
    ops = led.assign_sum_ops(1 << 19, 256, 128)
    _b, info = td.resolve_dispatch_batch(
        0, n_chunks=100, chunk_device_bytes=(1 << 19) * 128,
        flops_per_chunk=ops, precision=precision)
    assert info["compute_source"] == "roofline_estimate"
    assert info["compute_ms_per_chunk"] == round(ops / peak * 1e3, 4)


def test_a_finish_waits_for_its_events_outside_the_ledger_lock(
        monkeypatch):
    """A job's finish waits for its own pending end events without the
    ledger's lock: another thread dispatches meanwhile (a failed job's
    finish may wait for work still queued on the card)."""
    import threading

    _fresh()
    waiting, release = threading.Event(), threading.Event()

    class _Queued(_FakeEvent):
        def synchronize(self) -> None:
            waiting.set()
            assert release.wait(30)
            super().synchronize()

    made = []

    def event(stream):
        made.append((_Queued if len(made) == 1 else _FakeEvent)(
            2.5 * len(made), []))
        return made[-1]

    monkeypatch.setattr(led, "_sample_stream", lambda args: "stream")
    monkeypatch.setattr(led, "_timing_event", event)
    prog = led.observed("test/card", lambda x: _CardTensor())
    obs = Obs.from_config(JobConfig(backend="cpu"))
    prog(_CardTensor())  # the compile: sampled, its end still queued
    assert len(made) == 2 and not made[1].done
    finish = threading.Thread(target=led.LEDGER.resolve, args=(obs,))
    finish.start()
    other = None
    try:
        assert waiting.wait(30)
        other = threading.Thread(target=prog, args=(_CardTensor(),))
        other.start()
        other.join(10)
        assert not other.is_alive()
    finally:
        release.set()
        finish.join(30)
        if other is not None:
            other.join(30)
    stats = led.LEDGER.programs["test/card"]
    assert stats.dispatches == 2
    assert stats.samples == 1 and 1.5 < stats.sampled_ms <= 2.5
    obs.finish_xprof()
