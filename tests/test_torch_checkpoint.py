"""Checkpoint/resume in the port: a word count killed mid-map resumes
without re-mapping the spilled prefix and writes the bytes of a fresh run
(native and Python map, byte ranges and round-robin chunks), spills cross
between the two packages, and the device k-means fit resumes from its
per-iteration snapshot bit-equal to an uninterrupted fit."""

import json
import os

import numpy as np
import pytest
import torch

from map_oxidize_tpu.api import SumReducer as JaxSumReducer
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.driver import (
    run_wordcount_job as jax_run_wordcount_job,
)
from map_oxidize_tpu.workloads.wordcount import (
    WordCountMapper as JaxWordCountMapper,
)
from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
from map_oxidize_tpu_torch.runtime.driver import (
    run_kmeans_job,
    run_wordcount_job,
)
from map_oxidize_tpu_torch.workloads import kmeans as tkm
from map_oxidize_tpu_torch.workloads.wordcount import WordCountMapper

torch.set_num_threads(2)


def _make_corpus(path, n_lines=4000, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"Gamma,", b"delta.", b"epsilon", b"zeta"]
    extra = [b"w%d" % i for i in range(300)]
    with open(path, "wb") as f:
        for _ in range(n_lines):
            k = int(rng.integers(3, 9))
            f.write(b" ".join(words[int(i)] for i in rng.integers(0, 6, k)))
            f.write(b" " + extra[int(rng.integers(0, 300))] + b"\n")


class _DyingMapper(WordCountMapper):
    """Aborts the run after ``die_after`` chunks — the mid-run kill — on
    either map path: the Python ``map_chunk`` or the native ``map_file``
    iterator (which the driver runs in its prefetch thread)."""

    def __init__(self, die_after: int, **kw):
        super().__init__(**kw)
        self.mapped = 0
        self.die_after = die_after
        self.start_offsets = []

    def _tick(self):
        if self.mapped >= self.die_after:
            raise KeyboardInterrupt("simulated kill")
        self.mapped += 1

    def map_chunk(self, chunk):
        self._tick()
        return super().map_chunk(chunk)

    def map_file(self, path, chunk_bytes, start_offset=0):
        it = super().map_file(path, chunk_bytes, start_offset)
        if it is None:
            return None
        self.start_offsets.append(start_offset)

        def gen():
            for item in it:
                self._tick()
                yield item
        return gen()


def _cfg(corpus, out, ckdir, **kw):
    base = dict(input_path=str(corpus), output_path=str(out),
                checkpoint_dir=ckdir, chunk_bytes=16 * 1024, backend="cpu",
                metrics=False, num_map_workers=1, max_retries=0)
    base.update(kw)
    return JobConfig(**base)


def _kill_then_resume(tmp_path, corpus, die_after, use_native, **kw):
    """Kill after ``die_after`` chunks, resume, and hold the output to a
    fresh run's bytes; returns the resumed result and its mapper."""
    ckdir = str(tmp_path / "ck")
    want_out = tmp_path / "want.txt"
    run_job(_cfg(corpus, want_out, None, **kw), "wordcount")
    got_out = tmp_path / "got.txt"
    dying = _DyingMapper(die_after, use_native=use_native)
    with pytest.raises(KeyboardInterrupt):
        run_wordcount_job(_cfg(corpus, got_out, ckdir, **kw), dying,
                          SumReducer())
    saved = sorted(n for n in os.listdir(ckdir) if n.endswith(".npz"))
    assert saved == [f"chunk_{i:06d}.npz" for i in range(die_after)]
    counting = _DyingMapper(10**9, use_native=use_native)
    res = run_wordcount_job(_cfg(corpus, got_out, ckdir, **kw), counting,
                            SumReducer())
    assert got_out.read_bytes() == want_out.read_bytes()
    return res, counting


@pytest.mark.parametrize("use_native", [True, False])
def test_resume_after_kill_byte_identical(tmp_path, use_native):
    corpus = tmp_path / "corpus.txt"
    _make_corpus(corpus)
    res, counting = _kill_then_resume(tmp_path, corpus, 3, use_native)
    total = res.metrics["chunks"]
    assert total > 6
    assert counting.mapped == total - 3  # the prefix was replayed
    assert res.metrics["checkpoint/chunks_replayed"] == 3
    if use_native:
        # the native scan resumed at the third chunk's end offset
        assert len(counting.start_offsets) == 1
        assert counting.start_offsets[0] > 0
    assert not os.path.isdir(tmp_path / "ck")  # success removes the spill


def test_keep_intermediates_preserves_spill(tmp_path):
    corpus = tmp_path / "corpus.txt"
    _make_corpus(corpus, n_lines=1500)
    ckdir = tmp_path / "ck"
    run_job(_cfg(corpus, tmp_path / "o.txt", str(ckdir),
                 keep_intermediates=True), "wordcount")
    names = os.listdir(ckdir)
    assert "meta.json" in names
    n_saved = sum(n.endswith(".npz") for n in names)
    assert n_saved > 1
    # a second identical run replays everything, maps nothing, matches
    counting = _DyingMapper(10**9)
    res = run_wordcount_job(_cfg(corpus, tmp_path / "o2.txt", str(ckdir),
                                 keep_intermediates=True), counting,
                            SumReducer())
    assert counting.mapped == 0
    assert res.metrics["checkpoint/chunks_replayed"] == n_saved
    assert (tmp_path / "o.txt").read_bytes() == (
        tmp_path / "o2.txt").read_bytes()


def test_checkpoint_invalidated_on_different_job(tmp_path):
    corpus = tmp_path / "corpus.txt"
    _make_corpus(corpus, n_lines=1500)
    other = tmp_path / "other.txt"
    _make_corpus(other, n_lines=1700, seed=1)
    ckdir = str(tmp_path / "ck")
    run_job(_cfg(corpus, tmp_path / "o.txt", ckdir, keep_intermediates=True),
            "wordcount")
    # same dir, different input: the stale spill is discarded, not replayed
    res = run_job(_cfg(other, tmp_path / "o2.txt", ckdir), "wordcount")
    run_job(_cfg(other, tmp_path / "o3.txt", None), "wordcount")
    # a counter, as in the JAX package: no chunk replayed, no key
    assert "checkpoint/chunks_replayed" not in res.metrics
    assert (tmp_path / "o2.txt").read_bytes() == (
        tmp_path / "o3.txt").read_bytes()
    m1 = CheckpointStore.job_meta(_cfg(corpus, "", ckdir), "wordcount")
    assert m1 != CheckpointStore.job_meta(_cfg(corpus, "", ckdir), "bigram")
    assert m1 != CheckpointStore.job_meta(
        _cfg(corpus, "", ckdir, chunk_bytes=8192), "wordcount")


@pytest.mark.parametrize("use_native", [True, False])
def test_round_robin_mode_resumes_by_index(tmp_path, use_native):
    corpus = tmp_path / "corpus.txt"
    _make_corpus(corpus, n_lines=800)
    res, counting = _kill_then_resume(tmp_path, corpus, 2, use_native,
                                      num_chunks=6)
    assert counting.mapped == 4  # 6 chunks, 2 replayed
    assert res.metrics["chunks"] == 6


def _jax_cfg(corpus, out, ckdir, **kw):
    base = dict(input_path=str(corpus), output_path=str(out),
                checkpoint_dir=ckdir, chunk_bytes=16 * 1024, backend="cpu",
                num_shards=1, metrics=False, num_map_workers=1,
                max_retries=0, mapper="native")
    base.update(kw)
    return JaxJobConfig(**base)


class _JaxDying(JaxWordCountMapper):
    def __init__(self, die_after: int):
        super().__init__(use_native=False)
        self.mapped = 0
        self.die_after = die_after

    def map_chunk(self, chunk):
        if self.mapped >= self.die_after:
            raise KeyboardInterrupt("simulated kill")
        self.mapped += 1
        return super().map_chunk(chunk)


def test_jax_spill_resumes_in_the_port_and_back(tmp_path):
    """The format is framework-neutral: a prefix spilled by the JAX package
    resumes in the port, and one spilled by the port resumes in the JAX
    package, each to the bytes of a fresh run."""
    corpus = tmp_path / "corpus.txt"
    _make_corpus(corpus)
    want = tmp_path / "want.txt"
    run_job(_cfg(corpus, want, None), "wordcount")

    ck = str(tmp_path / "ck_from_jax")
    with pytest.raises(KeyboardInterrupt):
        jax_run_wordcount_job(_jax_cfg(corpus, tmp_path / "x.txt", ck),
                              _JaxDying(3), JaxSumReducer())
    counting = _DyingMapper(10**9)
    out = tmp_path / "port.txt"
    res = run_wordcount_job(_cfg(corpus, out, ck), counting, SumReducer())
    assert res.metrics["checkpoint/chunks_replayed"] == 3
    assert counting.mapped == res.metrics["chunks"] - 3
    assert out.read_bytes() == want.read_bytes()

    ck = str(tmp_path / "ck_from_port")
    with pytest.raises(KeyboardInterrupt):
        run_wordcount_job(_cfg(corpus, tmp_path / "y.txt", ck),
                          _DyingMapper(3), SumReducer())
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    assert meta["version"] == 1 and "framework" not in json.dumps(meta)
    resumed = _JaxDying(10**9)
    out = tmp_path / "jax.txt"
    r = jax_run_wordcount_job(_jax_cfg(corpus, out, ck), resumed,
                              JaxSumReducer())
    assert resumed.mapped == r.metrics["chunks"] - 3
    assert out.read_bytes() == want.read_bytes()


# --- k-means ---------------------------------------------------------------

def _blobs(seed, n=3000, d=6, k=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, size=(k, d)).astype(np.float32)
    pts = (centers[rng.integers(0, k, size=n)]
           + rng.normal(0, 1.5, size=(n, d))).astype(np.float32)
    return pts  # overlapping blobs: the centroids move for many iterations


def _km_cfg(inp, iters, ckdir, **kw):
    base = dict(input_path=str(inp), output_path="", backend="cpu",
                kmeans_k=5, kmeans_iters=iters, checkpoint_dir=ckdir,
                metrics=False)
    base.update(kw)
    return JobConfig(**base)


def _kill_fit_after(monkeypatch, i: int):
    """Make the next fit raise from ``on_iter`` after iteration ``i``."""
    real = tkm.kmeans_fit_device

    def dying(*a, on_iter=None, **kw):
        def hook(j, c):
            on_iter(j, c)
            if j == i:
                raise KeyboardInterrupt("simulated kill")
        return real(*a, on_iter=hook, **kw)

    monkeypatch.setattr(tkm, "kmeans_fit_device", dying)
    return lambda: monkeypatch.setattr(tkm, "kmeans_fit_device", real)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("killed_at", [1, 4])
def test_kmeans_kill_and_resume_is_bit_equal(tmp_path, monkeypatch,
                                             precision, killed_at):
    """Killed after ``killed_at`` of 7 iterations and resumed: the centroids
    are bit-equal to an uninterrupted fit of the port, and within atol 1e-4
    (the ``test_torch_kmeans`` bound) of the JAX package's resumed fit."""
    inp = tmp_path / "p.npy"
    np.save(inp, _blobs(3))
    want = run_job(_km_cfg(inp, 7, None, kmeans_precision=precision),
                   "kmeans")
    ck = str(tmp_path / "ck")
    restore = _kill_fit_after(monkeypatch, killed_at)
    with pytest.raises(KeyboardInterrupt):
        run_job(_km_cfg(inp, 7, ck, kmeans_precision=precision), "kmeans")
    restore()
    cfg = _km_cfg(inp, 7, ck, kmeans_precision=precision)
    res = run_job(cfg, "kmeans")
    assert res.centroids.tobytes() == want.centroids.tobytes()
    assert res.metrics["resumed_iters"] == killed_at
    assert res.metrics["records_in"] == 3000 * (7 - killed_at)
    assert res.metrics["iters"] == 7
    assert not os.path.isdir(ck)

    jck = str(tmp_path / "jck")
    jkw = dict(input_path=str(inp), output_path="", backend="cpu",
               num_shards=1, kmeans_k=5, mapper="device", metrics=False,
               kmeans_precision=precision, checkpoint_dir=jck)
    jax_run_job(JaxJobConfig(kmeans_iters=killed_at, keep_intermediates=True,
                             **jkw), "kmeans")
    j = jax_run_job(JaxJobConfig(kmeans_iters=7, **jkw), "kmeans")
    np.testing.assert_allclose(res.centroids, j.centroids, atol=1e-4, rtol=0)


def test_kmeans_identity_mismatch_discards_the_snapshot(tmp_path):
    inp = tmp_path / "p.npy"
    np.save(inp, _blobs(4))
    ck = str(tmp_path / "ck")
    run_job(_km_cfg(inp, 2, ck, keep_intermediates=True), "kmeans")
    for kw in (dict(kmeans_precision="bf16"), dict(kmeans_k=4)):
        got = run_job(_km_cfg(inp, 3, ck, keep_intermediates=True, **kw),
                      "kmeans")
        want = run_job(_km_cfg(inp, 3, None, **kw), "kmeans")
        assert "resumed_iters" not in got.metrics
        assert got.centroids.tobytes() == want.centroids.tobytes()
    # a different initial centroid set is identity too
    init = _blobs(5)[:5]
    run_kmeans_job(_km_cfg(inp, 2, ck, keep_intermediates=True))
    got = run_kmeans_job(_km_cfg(inp, 2, ck), centroids=init)
    want = run_kmeans_job(_km_cfg(inp, 2, None), centroids=init)
    assert "resumed_iters" not in got.metrics
    assert got.centroids.tobytes() == want.centroids.tobytes()


def test_kmeans_snapshot_covering_every_iteration_is_the_result(tmp_path):
    inp = tmp_path / "p.npy"
    np.save(inp, _blobs(6))
    ck = str(tmp_path / "ck")
    want = run_job(_km_cfg(inp, 3, ck, keep_intermediates=True), "kmeans")
    for iters in (3, 2):  # as many as the snapshot, and fewer
        got = run_job(_km_cfg(inp, iters, ck), "kmeans")
        assert got.centroids.tobytes() == want.centroids.tobytes()
        assert got.metrics["records_in"] == 0
        assert got.metrics["iters"] == 3
        assert os.path.isdir(ck)  # a zero-work read keeps the snapshot
