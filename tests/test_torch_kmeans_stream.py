"""The port's streamed k-means against the JAX package's: the fit streamed
through the device (``stream_device``), the host-assign stream (``stream``:
``KMeansMapper``, ``kmeans_iteration`` and the f32 vector fold), the mode
routing of ``run_job``, and kill-and-resume with the snapshot's mode adopted.
The port runs on the CPU backend, where the fused assign + sum is its plain
version; the JAX package runs as its own tests run it on the CPU."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from map_oxidize_tpu.api import SumReducer as JaxSumReducer
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.driver import make_engine as jax_make_engine
from map_oxidize_tpu.workloads import kmeans as jkm
from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.cli import main as cli_main
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
from map_oxidize_tpu_torch.runtime.driver import (
    _adopt_checkpoint_kmeans_mode,
    make_engine,
    run_kmeans_job,
)
from map_oxidize_tpu_torch.runtime.pipeline import (
    BlockStager,
    StagingRing,
    chunk_groups,
    pipelined,
)
from map_oxidize_tpu_torch.workloads import kmeans as tkm

torch.set_num_threads(2)

#: blob tolerance against the JAX package: the two sum the same partials in
#: another order (rtol 1e-5 / atol 1e-4, the ``test_torch_kmeans`` bound)
RTOL, ATOL = 1e-5, 1e-4


def _blobs(seed, n=5003, d=8, k=5):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 10, size=(k, d)).astype(np.float32)
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)
    pts[:k] = centres  # the first-k init starts one centroid in every blob
    return pts


def _int_blobs(seed, n=5003, d=8, k=5):
    """Integer points (|x| <= 63: exact in bf16 and f32, every sum exact)
    in clusters 20 apart, so no score comes near a tie."""
    rng = np.random.default_rng(seed)
    centres = 20 * rng.integers(-2, 3, size=(k, d))
    centres[:, 0] = 20 * np.arange(k) - 40  # k distinct centres
    pts = (centres[rng.integers(0, k, size=n)]
           + rng.integers(-3, 4, size=(n, d))).astype(np.float32)
    pts[:k] = centres
    return pts


def _save(tmp_path, pts, name="p.npy"):
    path = tmp_path / name
    np.save(path, pts)
    return str(path)


def _oracle(pts, init, iters):
    want = init
    for _ in range(iters):
        want = tkm.kmeans_model(pts, want)
    return want


def _round_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# --- kmeans_fit_streamed_device ------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_streamed_fit_matches_jax_and_the_oracle(tmp_path, precision):
    """Blobs, 3 iterations, 13 chunks with a ragged tail: within rtol 1e-5 /
    atol 1e-4 of the JAX package's streamed fit and of ``kmeans_model``
    (on the bf16-rounded points in bf16 mode: the blobs are separated far
    past the score's rounding, so the assignment is the oracle's)."""
    pts = _blobs(1)
    path = _save(tmp_path, pts)
    init = pts[:5].copy()
    timings = {}
    got = tkm.kmeans_fit_streamed_device(path, init, iters=3, chunk_rows=400,
                                         device="cpu", precision=precision,
                                         timings=timings, dispatch_batch=1)
    want = jkm.kmeans_fit_streamed_device(path, init, iters=3, chunk_rows=400,
                                          precision=precision,
                                          dispatch_batch=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    src = pts if precision == "highest" else _round_bf16(pts)
    np.testing.assert_allclose(got, _oracle(src, init, 3), rtol=RTOL,
                               atol=ATOL)
    assert {"feed_s", "dispatch_batch", "feed_wait_s",
            "overlap_ratio"} <= set(timings)
    assert timings["dispatch_batch"] == 1
    assert 0.0 <= timings["overlap_ratio"] <= 1.0


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_streamed_fit_is_bit_equal_to_jax_on_integer_inputs(tmp_path,
                                                            precision):
    """Integer points make every sum and count exact, so the port's fit,
    the JAX package's and the oracle agree bit for bit."""
    pts = _int_blobs(2)
    path = _save(tmp_path, pts)
    init = pts[:5].copy()
    partials = []
    got = tkm.kmeans_fit_streamed_device(path, init, iters=3, chunk_rows=700,
                                         device="cpu", precision=precision,
                                         partials=partials)
    want = jkm.kmeans_fit_streamed_device(path, init, iters=3, chunk_rows=700,
                                          precision=precision,
                                          dispatch_batch=2)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert got.tobytes() == _oracle(pts, init, 3).tobytes()
    # the first iteration's accumulator: one count per point, and the sums
    # of the points that the oracle assigns to each centroid
    assert len(partials) == 3
    cid = tkm.assign_points(pts, init)
    np.testing.assert_array_equal(partials[0][:, -1],
                                  np.bincount(cid, minlength=5))
    for j in range(5):
        np.testing.assert_array_equal(partials[0][j, :-1],
                                      pts[cid == j].sum(0))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 2, 3, 7])
def test_streamed_fit_is_bit_identical_across_b_and_depth(tmp_path, batch,
                                                          depth):
    """13 chunks of 400 rows with a 203-row tail; B=7 leaves a short last
    block.  The partials fold left in chunk order at every B and depth, so
    the centroids are bit-identical to B=1 at depth 1 (the serial
    schedule), in both precisions."""
    pts = _blobs(3)
    path = _save(tmp_path, pts)
    for precision in ("highest", "bf16"):
        kw = dict(iters=3, chunk_rows=400, device="cpu", precision=precision)
        want = tkm.kmeans_fit_streamed_device(path, pts[:5], **kw)
        got = tkm.kmeans_fit_streamed_device(path, pts[:5],
                                             pipeline_depth=depth,
                                             dispatch_batch=batch, **kw)
        assert got.tobytes() == want.tobytes()


def test_streamed_fit_single_chunk_and_tiny_chunks(tmp_path):
    """A chunk larger than the input is clipped to one chunk of n rows; one
    row per chunk also works.  Both within rounding of the oracle."""
    pts = _blobs(4, n=600, d=4, k=3)
    path = _save(tmp_path, pts)
    want = _oracle(pts, pts[:3], 2)
    for chunk_rows in (1 << 20, 1):
        got = tkm.kmeans_fit_streamed_device(path, pts[:3], iters=2,
                                             chunk_rows=chunk_rows,
                                             device="cpu")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_on_iter_sees_every_iteration(tmp_path):
    pts = _blobs(5, n=900, d=4, k=3)
    path = _save(tmp_path, pts)
    seen = []
    out = tkm.kmeans_fit_streamed_device(
        path, pts[:3], iters=3, chunk_rows=100, device="cpu",
        on_iter=lambda i, c: seen.append((i, c.copy())))
    assert [i for i, _ in seen] == [1, 2, 3]
    assert seen[-1][1].tobytes() == out.tobytes()
    np.testing.assert_allclose(seen[0][1], _oracle(pts, pts[:3], 1),
                               rtol=RTOL, atol=ATOL)


# --- the staging pipeline --------------------------------------------------


def test_chunk_groups_and_block_stager_keep_order():
    assert chunk_groups(range(7), 3) == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(ValueError, match="dispatch batch"):
        chunk_groups(range(3), 0)
    groups = chunk_groups(range(20), 3) * 2
    stager = BlockStager(groups, lambda g: sum(g), depth=2)
    assert list(stager) == [sum(g) for g in groups]
    assert 0.0 <= stager.overlap_ratio <= 1.0


def test_staging_ring_on_the_cpu_refuses_an_overrun():
    """On the CPU a slot is one host tensor and the block itself (no pinned
    memory); refilling a slot before its previous block was released is a
    bug that raises."""
    ring = StagingRing(2, 4, 3, torch.bfloat16, torch.device("cpu"))
    src = np.arange(12, dtype=np.float32).reshape(4, 3) + 0.1
    for seq in range(2):
        slot = ring.stage(seq, src[:3])
        block = ring.acquire(slot)
        assert not block.is_pinned()
        torch.testing.assert_close(block[:3], torch.from_numpy(
            src[:3]).to(torch.bfloat16), rtol=0, atol=0)
    ring.release(0, 0)
    ring.stage(2, src)  # slot 0, released
    with pytest.raises(RuntimeError, match="overrun"):
        ring.stage(3, src)  # slot 1 still holds block 1


def test_pipelined_reports_produce_and_wait_time():
    obs = Obs.from_config(JobConfig(backend="cpu"))
    assert list(pipelined(iter(range(9)), 3, obs)) == list(range(9))
    m = obs.registry.summary()
    assert m["pipeline/chunks"] == 9 and m["pipeline/depth"] == 3
    assert m["pipeline/produce_ms"] >= 0.0 and m["pipeline/feed_wait_ms"] >= 0.0
    assert 0.0 <= m["pipeline/overlap_ratio"] <= 1.0
    serial = iter(range(3))
    assert pipelined(serial, 1, obs) is serial


# --- the host-assign stream --------------------------------------------------


def test_mapper_partial_sums_match_jax():
    """Mirrors the JAX package's ``test_mapper_emits_partial_sums``: the
    same NumPy assign and bincounts, so the outputs are bit-equal."""
    pts = _blobs(6, n=300, d=3, k=4)
    init = pts[:4] + 0.25
    got = tkm.KMeansMapper(init).map_chunk(pts)
    want = jkm.KMeansMapper(init).map_chunk(pts)
    assert got.records_in == want.records_in == 300
    for a, b in ((got.hi, want.hi), (got.lo, want.lo),
                 (got.values, want.values)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert int(round(float(got.values[:, -1].sum()))) == 300
    assert tkm.KMeansMapper(init).map_chunk(pts[:0]).records_in == 0
    mapper, reducer = tkm.make_kmeans(init)
    assert mapper.value_shape == (4,) and reducer.combine == "sum"


def test_f32_vector_fold_matches_the_jax_engine():
    """The engine's ``(d+1,)`` f32 sum against the JAX package's
    ``make_engine(..., value_shape=(d+1,), value_dtype=float32)`` on the
    same mapped chunks, across several feed batches and a capacity growth:
    bit-equal (both sum each key's rows in feed order)."""
    pts = _blobs(7, n=20_000, d=16, k=8)
    init = pts[:8] + 0.5
    outs = [tkm.KMeansMapper(init).map_chunk(pts[i:i + 300])
            for i in range(0, 20_000, 300)]
    kw = dict(input_path="unused", output_path="", backend="cpu",
              batch_size=512, initial_key_capacity=4, metrics=False)
    eng = make_engine(JobConfig(**kw), SumReducer(), value_shape=(17,),
                      value_dtype=np.float32)
    jeng = jax_make_engine(JaxJobConfig(num_shards=1, **kw), JaxSumReducer(),
                           value_shape=(17,), value_dtype=np.float32)
    for out in outs:
        eng.feed(out)
        jeng.feed(out)
    got, want = eng.finalize(), jeng.finalize()
    assert got[3] == want[3] == 8
    for a, b in zip(got[:3], want[:3]):
        b = np.asarray(b)
        assert a.tobytes() == b.tobytes()


def test_iteration_matches_jax_and_the_oracle():
    """Mirrors ``test_streamed_iteration_matches_oracle`` (rtol/atol 1e-4
    there): the port's engine and iteration against the JAX package's on
    the same chunks, bit-equal; against the oracle within rtol 1e-5 /
    atol 1e-4."""
    pts = _blobs(8, n=4000)
    init = pts[:5] + 0.3
    chunks = [pts[i:i + 700] for i in range(0, 4000, 700)]
    kw = dict(input_path="unused", output_path="", backend="cpu",
              batch_size=512, metrics=False)
    got = tkm.kmeans_iteration(
        make_engine(JobConfig(**kw), SumReducer(), value_shape=(9,),
                    value_dtype=np.float32), init, chunks)
    want = jkm.kmeans_iteration(
        jax_make_engine(JaxJobConfig(num_shards=1, **kw), JaxSumReducer(),
                        value_shape=(9,), value_dtype=np.float32),
        init, chunks)
    assert got.tobytes() == np.asarray(want).tobytes()
    np.testing.assert_allclose(got, tkm.kmeans_model(pts, init), rtol=RTOL,
                               atol=ATOL)


def test_empty_centroid_keeps_position_and_conservation_violation_raises():
    cfg = JobConfig(input_path="unused", output_path="", backend="cpu",
                    metrics=False)
    pts = np.ones((50, 2), np.float32)
    init = np.array([[1.0, 1.0], [99.0, 99.0]], np.float32)
    new = tkm.kmeans_iteration(
        make_engine(cfg, SumReducer(), value_shape=(3,),
                    value_dtype=np.float32), init, [pts])
    np.testing.assert_array_equal(new, init)

    class Lossy(tkm.KMeansMapper):
        def map_chunk(self, points):
            out = super().map_chunk(points)
            out.records_in += 7  # claims more points than it summed
            return out

    with pytest.raises(RuntimeError, match="conservation"):
        tkm.kmeans_iteration(
            make_engine(cfg, SumReducer(), value_shape=(3,),
                        value_dtype=np.float32),
            init, [_blobs(9, n=100, d=2, k=2)], mapper=Lossy(init))


# --- run_job: the modes against the JAX package --------------------------


def _cfg(path, **kw):
    base = dict(input_path=path, output_path="", backend="cpu", kmeans_k=5,
                kmeans_iters=3, chunk_bytes=4096, metrics=False)
    base.update(kw)
    return base


@pytest.mark.parametrize("mapper,fit_bytes,mode", [
    ("native", 0, "stream"),
    ("python", 0, "stream"),
    ("auto", 64, "stream_device"),
    ("auto", 0, "device"),
])
def test_run_job_modes_match_jax(tmp_path, mapper, fit_bytes, mode):
    """Each mapper against the JAX package's ``run_job`` on the same file
    (mirrors ``test_auto_mapper_fit_cap``,
    ``test_auto_routes_beyond_fit_to_streamed_device`` and
    ``test_fit_budget_config_routes_stream_device``): the same
    ``kmeans_mode``, centroids within rtol 1e-5 / atol 1e-4 and the
    output file written."""
    pts = _blobs(10, n=4000, d=6)
    path = _save(tmp_path, pts)
    kw = _cfg(path, mapper=mapper, kmeans_device_fit_bytes=fit_bytes)
    out = str(tmp_path / "c.npy")
    res = run_job(JobConfig(**dict(kw, output_path=out)), "kmeans")
    j = jax_run_job(JaxJobConfig(num_shards=1, **dict(kw, metrics=True)),
                    "kmeans")
    assert res.metrics["kmeans_mode"] == j.metrics["kmeans_mode"] == mode
    assert res.metrics["kmeans_shards"] == 1
    np.testing.assert_allclose(res.centroids, j.centroids, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(res.centroids, _oracle(pts, pts[:5], 3),
                               rtol=RTOL, atol=ATOL)
    assert np.load(out).tobytes() == res.centroids.tobytes()
    assert res.metrics["records_in"] == 4000 * 3
    if mode == "stream_device":
        assert {"time/feed_s", "dispatch/batch",
                "pipeline/overlap_ratio"} <= set(res.metrics)
    if mode == "stream":
        assert {"time/iterate_s", "pipeline/overlap_ratio"} <= set(
            res.metrics)


def test_stream_device_chunking_follows_the_jax_formula(tmp_path,
                                                       monkeypatch):
    """``stream_device`` chunks are ``chunk_bytes // (4 (d + 2k))`` rows and
    ``dispatch_batch=0`` resolves B through the dispatch resolver: with a
    0.001 ms launch floor every rule gives B=1."""
    from map_oxidize_tpu_torch.runtime import dispatch

    monkeypatch.setattr(dispatch, "_auto_cache", {})
    monkeypatch.setenv("MOXT_DISPATCH_FLOOR_MS", "0.001")
    pts = _blobs(11, n=3000, d=6)
    path = _save(tmp_path, pts)
    seen = {}
    real = tkm.kmeans_fit_streamed_device

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tkm, "kmeans_fit_streamed_device", spy)
    res = run_job(JobConfig(**_cfg(path, kmeans_device_fit_bytes=64)),
                  "kmeans")
    assert seen["chunk_rows"] == 4096 // (4 * (6 + 2 * 5))
    assert res.metrics["dispatch/batch"] == 1
    assert res.metrics["dispatch/batch_mode"] == "auto"
    assert res.metrics["dispatch/floor_source"] == "env"


def test_cli_reaches_every_mode(tmp_path, capsys):
    """Every mapper through the CLI, and ``auto`` past a
    ``--kmeans-fit-bytes`` budget: the mode each reached
    (``--metrics-out``) and centroids that match the oracle."""
    pts = _blobs(12, n=2000, d=4, k=3)
    path = _save(tmp_path, pts)
    runs = {"auto": ([], "device"), "device": ([], "device"),
            "native": ([], "stream"), "python": ([], "stream"),
            "auto_fit": (["--kmeans-fit-bytes", "64", "--chunk-mb", "1"],
                         "stream_device")}
    outs = {}
    for name, (flags, mode) in runs.items():
        out = str(tmp_path / f"{name}.npy")
        doc = tmp_path / f"{name}.json"
        assert cli_main(["kmeans", path, "--backend", "cpu", "--mapper",
                         name.split("_")[0], "--kmeans-k", "3",
                         "--kmeans-iters", "2", "--output", out,
                         "--metrics-out", str(doc), "-q"] + flags) == 0
        assert json.loads(doc.read_text())["gauges"]["kmeans_mode"] == mode
        outs[name] = np.load(out)
    assert "3 centroids" in capsys.readouterr().out
    for got in outs.values():
        np.testing.assert_allclose(got, _oracle(pts, pts[:3], 2), rtol=RTOL,
                                   atol=ATOL)


# --- kill and resume ---------------------------------------------------------


def _kill_streamed_after(monkeypatch, i):
    real = tkm.kmeans_fit_streamed_device

    def dying(*a, on_iter=None, **kw):
        def hook(j, c):
            on_iter(j, c)
            if j == i:
                raise KeyboardInterrupt("simulated kill")
        return real(*a, on_iter=hook, **kw)

    monkeypatch.setattr(tkm, "kmeans_fit_streamed_device", dying)
    return lambda: monkeypatch.setattr(tkm, "kmeans_fit_streamed_device",
                                       real)


def _kill_iteration_after(monkeypatch, i):
    real = tkm.kmeans_iteration
    calls = {"n": 0}

    def dying(*a, **kw):
        if calls["n"] == i:
            raise KeyboardInterrupt("simulated kill")
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tkm, "kmeans_iteration", dying)
    return lambda: monkeypatch.setattr(tkm, "kmeans_iteration", real)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("mode", ["stream_device", "stream"])
def test_kill_and_resume_is_bit_equal(tmp_path, monkeypatch, mode,
                                      precision):
    """Killed after 2 of 5 iterations (an ``on_iter`` that raises, or an
    interrupted host-assign iteration) and resumed: bit-equal to an
    uninterrupted run, 3 iterations run, the snapshot removed."""
    pts = _blobs(13, n=3000)
    path = _save(tmp_path, pts)
    kw = _cfg(path, kmeans_iters=5, kmeans_precision=precision,
              **({"kmeans_device_fit_bytes": 64} if mode == "stream_device"
                 else {"mapper": "native"}))
    want = run_job(JobConfig(**kw), "kmeans")
    assert want.metrics["kmeans_mode"] == mode
    ck = str(tmp_path / "ck")
    kill = (_kill_streamed_after if mode == "stream_device"
            else _kill_iteration_after)
    restore = kill(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        run_job(JobConfig(checkpoint_dir=ck, **kw), "kmeans")
    restore()
    res = run_job(JobConfig(checkpoint_dir=ck, **kw), "kmeans")
    assert res.centroids.tobytes() == want.centroids.tobytes()
    assert res.metrics["resumed_iters"] == 2
    assert res.metrics["records_in"] == 3000 * 3
    assert res.metrics["kmeans_mode"] == mode
    assert not os.path.isdir(ck)


@pytest.mark.parametrize("cut_from", ["stream", "stream_device"])
def test_auto_resume_adopts_the_snapshot_mode(tmp_path, cut_from):
    """Mirrors the JAX package's ``test_auto_resume_adopts_snapshot_mode``:
    a snapshot cut from a streamed mode resumes in that mode under
    ``mapper='auto'`` even where the heuristic now picks the device fit
    (a fit budget raised past the working set), bit-equal to an
    uninterrupted run of that mode."""
    pts = _blobs(14, n=2000)
    path = _save(tmp_path, pts)
    cut = (dict(mapper="native") if cut_from == "stream"
           else dict(mapper="auto", kmeans_device_fit_bytes=64))
    want = run_job(JobConfig(**_cfg(path, kmeans_iters=4, **cut)), "kmeans")
    ck = str(tmp_path / "ck")
    run_job(JobConfig(**_cfg(path, kmeans_iters=2, checkpoint_dir=ck,
                             keep_intermediates=True, **cut)), "kmeans")
    res = run_job(JobConfig(**_cfg(path, kmeans_iters=4, checkpoint_dir=ck,
                                   mapper="auto",
                                   kmeans_device_fit_bytes=1 << 40)),
                  "kmeans")
    assert res.metrics["kmeans_mode"] == cut_from
    assert res.metrics["resumed_iters"] == 2
    assert res.centroids.tobytes() == want.centroids.tobytes()
    assert not os.path.isdir(ck)


def test_foreign_snapshot_does_not_flip_the_mode(tmp_path):
    """A streamed snapshot of another job (another k, another init) leaves
    ``auto`` on its heuristic, and the job starts fresh."""
    pts = _blobs(15, n=2000)
    path = _save(tmp_path, pts)
    ck = str(tmp_path / "ck")
    run_job(JobConfig(**_cfg(path, kmeans_iters=2, checkpoint_dir=ck,
                             keep_intermediates=True, mapper="native")),
            "kmeans")
    cfg = JobConfig(**_cfg(path, kmeans_k=4, checkpoint_dir=ck))
    res = run_job(cfg, "kmeans")
    assert res.metrics["kmeans_mode"] == "device"
    assert "resumed_iters" not in res.metrics
    fresh = run_job(dataclasses.replace(cfg, checkpoint_dir=None), "kmeans")
    assert res.centroids.tobytes() == fresh.centroids.tobytes()
    # the same job with another init: the mode is not adopted either
    run_job(JobConfig(**_cfg(path, kmeans_iters=2, checkpoint_dir=ck,
                             keep_intermediates=True, mapper="native")),
            "kmeans")
    res = run_kmeans_job(JobConfig(**_cfg(path, checkpoint_dir=ck)),
                         centroids=pts[5:10])
    assert res.metrics["kmeans_mode"] == "device"
    assert "resumed_iters" not in res.metrics


def test_adopt_reads_only_a_matching_snapshot(tmp_path):
    pts = _blobs(16, n=500, d=4, k=3)
    path = _save(tmp_path, pts)
    ck = str(tmp_path / "ck")
    cfg = JobConfig(**_cfg(path, kmeans_k=3, checkpoint_dir=ck,
                           keep_intermediates=True, mapper="python"))
    assert _adopt_checkpoint_kmeans_mode(cfg, {}) is None  # no meta.json
    run_job(cfg, "kmeans")
    meta = CheckpointStore.job_meta(cfg, "kmeans", extra={
        "kmeans_k": 3, "kmeans_backend": "cpu",
        "kmeans_precision": "highest",
        "kmeans_init": hashlib.sha256(
            np.asarray(pts[:3], np.float32).tobytes()).hexdigest()[:16]})
    assert _adopt_checkpoint_kmeans_mode(cfg, meta) == "stream"
    assert _adopt_checkpoint_kmeans_mode(
        cfg, dict(meta, kmeans_precision="bf16")) is None
