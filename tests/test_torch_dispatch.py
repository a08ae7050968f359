"""The port's dispatch-batch resolver against the JAX package's
(``runtime/dispatch.py``, ``runtime/planner.py`` ``solve_batch``): the
roofline solver over a grid of (floor, compute, produce), the resolution
``(B, info)`` of the same inputs (a pin, the chunk cap, the defaults, an
env floor, measured ledger figures, a calibration curve, the roofline
estimate, the device-memory cap and the memo), the gauges it records, and
a ``stream_device`` k-means fit with ``dispatch_batch=0`` in both packages
(centroids within the stream tolerance, the same ``dispatch/*`` and
``plan/dispatch_*`` keys) whose centroids are bit-equal across B."""

import itertools
import types

import numpy as np
import pytest

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import calib as jax_calib
from map_oxidize_tpu.obs.compile import LEDGER as JAX_LEDGER
from map_oxidize_tpu.obs.context import use_obs as jax_use_obs
from map_oxidize_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from map_oxidize_tpu.runtime import dispatch as jd
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.planner import solve_batch as jax_solve_batch
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import calib
from map_oxidize_tpu_torch.obs.compile import LEDGER
from map_oxidize_tpu_torch.obs.context import use_obs
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.runtime import dispatch as td
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.planner import solve_batch
from map_oxidize_tpu_torch.workloads import kmeans as tkm

#: the stream tolerance of the k-means tests (rtol 1e-5, atol 1e-4)
RTOL, ATOL = 1e-5, 1e-4
PROGRAM = "kmeans/stream_step"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both resolvers as in a fresh process: empty memos, no program
    stats of the stream step, no env floor or peak."""
    monkeypatch.setattr(td, "_auto_cache", {})
    monkeypatch.setattr(jd, "_auto_cache", {})
    for led in (LEDGER, JAX_LEDGER):
        led.programs.pop(PROGRAM, None)
    for env in ("MOXT_DISPATCH_FLOOR_MS", "MOXT_PEAK_FLOPS",
                "MOXT_PEAK_MEMBW"):
        monkeypatch.delenv(env, raising=False)
    yield
    for led in (LEDGER, JAX_LEDGER):
        led.programs.pop(PROGRAM, None)


# --- the solver -------------------------------------------------------------

FLOORS = (0.0, 0.01, 1.0, 37.5, 150.0)
COMPUTES = (None, 0.0, 0.02, 0.7, 12.0)
PRODUCES = (None, 0.0, 0.04, 0.9, 30.0)


@pytest.mark.parametrize("floor,compute,produce", list(
    itertools.product(FLOORS, COMPUTES, PRODUCES)))
def test_solve_batch_matches_jax(floor, compute, produce):
    for default_auto, max_b in ((4, 64), (1, 8)):
        assert solve_batch(floor, compute, produce, default_auto, max_b) == (
            jax_solve_batch(floor, compute, produce, default_auto, max_b))


# --- resolution -------------------------------------------------------------


def _seed_stats(floor_ms=None, compute_ms=None, chunks_per_dispatch=1):
    """The same stream-step history in both ledgers: 10 steady dispatches
    of ``floor_ms`` each and 4 samples of ``compute_ms``."""
    for led in (LEDGER, JAX_LEDGER):
        p = led._stats(PROGRAM)
        p.compiles, p.dispatches = 1, 11
        if floor_ms is not None:
            p.dispatch_ms = 10 * floor_ms
        p.chunks = 10 * chunks_per_dispatch
        if compute_ms is not None:
            p.sampled_ms, p.samples = 4 * compute_ms, 4


def _curve_obs(pkg, ident, dispatch_ms=2.5, compute_ms=0.3):
    """A bound-able job stand-in whose ``calib_prior`` holds a stream-step
    program row under ``ident``."""
    mod = calib if pkg == "port" else jax_calib
    store = mod.CalibStore()
    store.accumulate_run(ident, [], {"programs": {PROGRAM: {
        "dispatches": 40, "compiles": 1, "dispatch_ms": 40 * dispatch_ms,
        "sampled_device_ms": 5 * compute_ms, "device_samples": 5,
        "compile_ms": 3.0}}})
    return types.SimpleNamespace(calib_prior=store, n_processes=1)


def _both(case, monkeypatch, **kw):
    """Resolve ``kw`` in both packages under ``case``'s conditions."""
    if case == "env_floor":
        monkeypatch.setenv("MOXT_DISPATCH_FLOOR_MS", "3.25")
    elif case == "measured":
        _seed_stats(floor_ms=0.8, compute_ms=1.6, chunks_per_dispatch=4)
    elif case == "roofline":
        monkeypatch.setenv("MOXT_PEAK_FLOPS", "2e12")
    elif case == "hbm_cap":
        monkeypatch.setattr(td, "hbm_budget_bytes", lambda: 64 << 20)
        monkeypatch.setattr(jd, "hbm_budget_bytes", lambda: 64 << 20)
    if case == "calib_curve":
        from map_oxidize_tpu_torch.runtime.engine import pick_device

        pick_device("cpu")
        port_obs = _curve_obs("port", calib.run_identity())
        jax_obs = _curve_obs("jax", jax_calib.run_identity())
        with use_obs(port_obs):
            mine = td.resolve_dispatch_batch(**kw)
        with jax_use_obs(jax_obs):
            theirs = jd.resolve_dispatch_batch(**kw)
        return mine, theirs
    return td.resolve_dispatch_batch(**kw), jd.resolve_dispatch_batch(**kw)


CASES = {
    "fixed": dict(requested=3, n_chunks=10),
    "fixed_capped_by_chunks": dict(requested=12, n_chunks=5),
    "auto_no_measurements": dict(requested=0, n_chunks=100),
    "auto_produce_only": dict(requested=0, n_chunks=100, produce_ms=0.4),
    "auto_capped_by_chunks": dict(requested=0, n_chunks=3, produce_ms=0.01),
    "env_floor": dict(requested=0, n_chunks=100, produce_ms=0.5),
    "measured": dict(requested=0, n_chunks=100, produce_ms=0.3),
    "calib_curve": dict(requested=0, n_chunks=100, produce_ms=0.2),
    "roofline": dict(requested=0, n_chunks=100, flops_per_chunk=4e9,
                     chunk_device_bytes=1 << 20),
    "hbm_cap": dict(requested=0, n_chunks=100, produce_ms=0.001,
                    chunk_device_bytes=4 << 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolve_matches_jax(case, monkeypatch):
    mine, theirs = _both(case, monkeypatch, **CASES[case])
    assert mine == theirs
    b, info = mine
    assert info["batch"] == b >= 1
    if case.startswith("auto") or case in ("env_floor", "measured",
                                           "calib_curve", "roofline"):
        assert info["mode"] == "auto"
    assert info.get("floor_source") == {
        "env_floor": "env", "measured": "measured",
        "calib_curve": "calib_curve"}.get(
            case, None if case.startswith("fixed") else "platform_default")
    if case == "hbm_cap":
        assert info["hbm_cap"] == 4 and info["rule"].endswith("+hbm_capped")


def test_the_memo_holds_the_first_resolution(monkeypatch):
    """A second auto resolution of the same (program, shape, platform)
    returns the first one's B and evidence whatever the new inputs, in
    both packages; the probes see it."""
    kw = dict(n_chunks=100, chunk_device_bytes=1 << 16,
              flops_per_chunk=1e6)
    for mod in (td, jd):
        assert not mod.has_cached_auto(PROGRAM, 1 << 16, 1e6)
        assert not mod.has_any_cached_auto(PROGRAM)
    first = _both("auto", monkeypatch, requested=0, produce_ms=0.3, **kw)
    again = _both("auto", monkeypatch, requested=0, produce_ms=9.0, **kw)
    assert first[0] == first[1] and again == first
    for mod in (td, jd):
        assert mod.has_cached_auto(PROGRAM, 1 << 16, 1e6)
        assert not mod.has_cached_auto(PROGRAM, 1 << 17, 1e6)
        assert mod.has_any_cached_auto(PROGRAM)


def test_measured_figures_match_jax():
    _seed_stats(floor_ms=0.6, compute_ms=2.0, chunks_per_dispatch=2)
    for fn in ("measured_dispatch_floor_ms", "measured_compute_ms_per_chunk",
               "dispatch_floor_snapshot"):
        assert getattr(td, fn)(PROGRAM) == getattr(jd, fn)(PROGRAM)
    since = td.dispatch_floor_snapshot(PROGRAM)
    for led in (LEDGER, JAX_LEDGER):
        p = led.programs[PROGRAM]
        p.dispatch_ms += 5 * 0.25
        p.dispatches += 5
    assert td.measured_dispatch_floor_ms(PROGRAM, since) == pytest.approx(
        0.25) == jd.measured_dispatch_floor_ms(PROGRAM, since)
    assert td.measured_dispatch_floor_ms("nope") is None


@pytest.mark.parametrize("case", ["fixed", "auto_produce_only", "roofline"])
@pytest.mark.parametrize("fresh_probe", [None, 4.5])
def test_record_dispatch_batch_matches_jax(case, fresh_probe, monkeypatch):
    (b, info), (jb, jinfo) = _both(case, monkeypatch, **CASES[case])
    mine, theirs = MetricsRegistry(), JaxRegistry()
    td.record_dispatch_batch(mine, b, info, fresh_probe_ms=fresh_probe)
    jd.record_dispatch_batch(theirs, jb, jinfo, fresh_probe_ms=fresh_probe)
    assert mine.summary() == theirs.summary()
    assert ("attrib/probe_ms" in mine.summary()) == bool(fresh_probe)
    assert mine.summary()["plan/dispatch_batch"] == b


def test_hbm_budget_reads_no_cuda():
    import torch

    assert td.hbm_budget_bytes() == 0 and td._platform() == "cpu"
    assert not torch.cuda.is_initialized()


# --- the streamed fit -------------------------------------------------------


def _points(seed=5, n=4000, d=6, k=5):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:k] = centres
    return pts


def _fresh_stream_step():
    for led in (LEDGER, JAX_LEDGER):
        led.programs.pop(PROGRAM, None)
    td._auto_cache.clear()
    jd._auto_cache.clear()


def test_auto_stream_device_fit_matches_jax(tmp_path, monkeypatch):
    """``dispatch_batch=0`` through both job drivers (``stream_device``,
    the JAX package at one shard) with the launch floor pinned by
    ``MOXT_DISPATCH_FLOOR_MS``: the same B and the same
    ``dispatch/*`` and ``plan/dispatch_*`` keys, with a fresh produce probe
    in ``attrib/probe_ms``; the centroids agree within the stream
    tolerance."""
    path = tmp_path / "p.npy"
    np.save(path, _points())
    monkeypatch.setenv("MOXT_DISPATCH_FLOOR_MS", "0.001")
    kw = dict(input_path=str(path), backend="cpu", metrics=False,
              output_path="", kmeans_k=5, kmeans_iters=3,
              chunk_bytes=4096, kmeans_device_fit_bytes=64)
    _fresh_stream_step()
    mine = run_job(JobConfig(**kw), "kmeans")
    theirs = jax_run_job(JaxJobConfig(num_shards=1, **kw), "kmeans")
    assert mine.metrics["kmeans_mode"] == "stream_device"

    def record(m):
        return {k for k in m if k.startswith(("dispatch/", "plan/dispatch_"))}

    assert record(mine.metrics) == record(theirs.metrics)
    assert {"dispatch/floor_source", "dispatch/produce_ms_per_chunk",
            "dispatch/rule", "plan/dispatch_floor_ms"} <= record(
                mine.metrics)
    # the rule reads the produce probe's wall (which side of 0.05 ms of
    # headroom), so only B and the floor compare by value
    for key in ("dispatch/batch", "dispatch/batch_mode",
                "dispatch/floor_source", "dispatch/floor_ms"):
        assert mine.metrics[key] == theirs.metrics[key]
    assert mine.metrics["attrib/probe_ms"] > 0
    np.testing.assert_allclose(mine.centroids, theirs.centroids, rtol=RTOL,
                               atol=ATOL)


def test_stream_device_centroids_are_bit_equal_across_b(tmp_path):
    """The left fold of per-chunk partials makes the fit bit-identical at
    B = 1, auto and 8 (a B that does not divide the 20 chunks)."""
    path = tmp_path / "p.npy"
    np.save(path, _points(n=3999))
    init = _points(n=3999)[:5].copy()
    outs = {}
    for b in (1, 0, 8):
        _fresh_stream_step()
        timings = {}
        outs[b] = tkm.kmeans_fit_streamed_device(
            str(path), init, iters=3, chunk_rows=200, device="cpu",
            dispatch_batch=b, timings=timings)
        assert timings["dispatch_batch"] == (b or timings["dispatch_batch"])
    assert outs[0].tobytes() == outs[1].tobytes() == outs[8].tobytes()
