"""Job drivers of the port: word count on one device, and k-means in its
three single-device modes (device-resident, streamed through the device,
host-assign stream).

Cut down from the JAX package's driver to the single-device fold.  The map
runs in a bounded prefetch thread (:mod:`~map_oxidize_tpu_torch.runtime.
pipeline`): the native C++ mmap scan, or the Python map through the worker
pool of :mod:`~map_oxidize_tpu_torch.runtime.executor`; the calling thread
feeds one :class:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine`,
and PyTorch's asynchronous launches let the device fold one batch while the
host maps the next chunks.  With ``checkpoint_dir`` set, word count spills
every mapped chunk and k-means snapshots every iteration
(:mod:`~map_oxidize_tpu_torch.runtime.checkpoint`); a re-run resumes.  There
is no observability bundle or push transport in this slice; the sharded
engines and the collect reduce raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import time
from collections.abc import Mapping
from dataclasses import dataclass, field

import numpy as np
import torch

from map_oxidize_tpu_torch.api import Mapper, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.splitter import (
    iter_chunks,
    plan_chunks,
    split_round_robin,
)
from map_oxidize_tpu_torch.io.writer import format_top_words, write_final_result
from map_oxidize_tpu_torch.ops.hashing import SENTINEL, HashDictionary, join_u64
from map_oxidize_tpu_torch.ops.topk import top_k_candidate_indices
from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
from map_oxidize_tpu_torch.runtime.engine import (
    DeviceReduceEngine,
    StreamingEngineBase,
    pick_device,
)
from map_oxidize_tpu_torch.runtime.executor import run_map_phase
from map_oxidize_tpu_torch.runtime.pipeline import overlap_ratio, pipelined
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


@dataclass
class JobResult:
    """``final_result.txt``'s counts, the top-k and metrics.  ``counts`` is
    a read-only Mapping (:class:`LazyCounts`)."""

    counts: "Mapping[bytes, int]"
    top: list[tuple[bytes, int]]
    metrics: dict = field(default_factory=dict)

    def top_report(self, k: int) -> str:
        return format_top_words(self.top, k)


def make_engine(config: JobConfig, reducer, value_shape=(),
                value_dtype=np.int32, wide_keys: bool = False):
    """The single-device streaming fold engine.  ``num_shards`` > 1 and the
    collect reduce (``reduce_mode='collect'``, or 'auto' for a wide-key
    mapper) are not ported yet and raise."""
    if config.num_shards > 1:
        raise NotImplementedError(
            "sharded engines over torch.distributed are not ported yet "
            "(ROADMAP: sharded engines); use num_shards=1")
    mode = config.reduce_mode
    if mode == "collect" or (mode == "auto" and wide_keys
                             and tuple(value_shape) == ()):
        raise NotImplementedError(
            "the collect reduce is not ported yet (ROADMAP: bigram and the "
            "collect route); use reduce_mode='fold'")
    return DeviceReduceEngine(config, reducer, value_shape=value_shape,
                              value_dtype=value_dtype)


class LazyCounts(Mapping):
    """{word_bytes: count} view over the engine's columnar readback.

    The total, the distinct-key count and the top-k are answered from the
    hash/value ARRAYS plus at most k string lookups; the real dict is
    materialized only when a consumer needs strings for every key (writing
    final_result.txt, dict comparisons)."""

    def __init__(self, k64: np.ndarray, vals: np.ndarray,
                 dictionary: HashDictionary):
        self._k64 = k64
        self._vals = vals
        self._dict = dictionary
        self._mat: dict[bytes, int] | None = None

    def __len__(self) -> int:
        return int(self._k64.shape[0])

    def total(self) -> int:
        """Σ counts, vectorized (the conservation-check input)."""
        return int(np.sum(self._vals, dtype=np.int64))

    def top_k(self, k: int) -> list[tuple[bytes, int]]:
        """Top-k by count descending, word ascending on ties: argpartition
        over the value column, strings materialized only for the <= k
        winners plus boundary-count ties."""
        if len(self) == 0:
            return []
        vals = self._vals
        cand = top_k_candidate_indices(vals, k)
        lookup = self._dict.lookup
        if cand.size > max(1024, 32 * k):
            # boundary-tie flood (Zipf tail: the k-th count is a heavily
            # tied low value).  Strict winners are < k and sort normally; of
            # the ties only the (k - strict) byte-smallest matter, which
            # heapq.nsmallest finds without sorting all of them
            import heapq

            cvals = vals[cand]
            kth = cvals.min()
            strict = cand[cvals > kth]
            pairs = [(lookup(int(h)), int(v))
                     for h, v in zip(self._k64[strict].tolist(),
                                     vals[strict].tolist())]
            pairs.sort(key=lambda kv: (-kv[1], kv[0]))
            need = k - len(pairs)
            if need > 0:
                ties = cand[cvals == kth]
                words = heapq.nsmallest(
                    need, (lookup(int(h)) for h in self._k64[ties].tolist()))
                pairs += [(w, int(kth)) for w in words]
            return pairs[:k]
        pairs = [(lookup(int(h)), int(v))
                 for h, v in zip(self._k64[cand].tolist(),
                                 vals[cand].tolist())]
        pairs.sort(key=lambda kv: (-kv[1], kv[0]))
        return pairs[:k]

    def _materialize(self) -> dict[bytes, int]:
        if self._mat is None:
            lookup = self._dict.materialized().__getitem__
            self._mat = {lookup(h): v for h, v in
                         zip(self._k64.tolist(), self._vals.tolist())}
            if len(self._mat) != len(self._k64):
                raise RuntimeError(
                    f"readback found {len(self._mat)} distinct words for "
                    f"{len(self._k64)} live keys")
        return self._mat

    def __getitem__(self, word: bytes) -> int:
        return self._materialize()[word]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, LazyCounts):
            other = other._materialize()
        return self._materialize() == other

    def __ne__(self, other):
        return not self.__eq__(other)

    def items(self):
        return self._materialize().items()


def _readback(engine: StreamingEngineBase, dictionary: HashDictionary
              ) -> LazyCounts:
    """Device accumulator -> :class:`LazyCounts`.  Padding rows carry the
    SENTINEL key, so mask."""
    hi, lo, vals, n = engine.finalize()
    live = ~((hi == np.uint32(SENTINEL)) & (lo == np.uint32(SENTINEL)))
    k64 = join_u64(hi[live], lo[live])
    if k64.shape[0] != n:
        raise RuntimeError(
            f"readback found {k64.shape[0]} live keys but engine reported {n}")
    # a duplicated live key means an engine bug split one key's count
    if np.unique(k64).shape[0] != n:
        raise RuntimeError(
            f"engine emitted duplicate live keys: {n} rows, "
            f"{np.unique(k64).shape[0]} distinct")
    return LazyCounts(k64, vals[live], dictionary)


def _track_offsets(chunk_iter, start_off: int, offsets: dict, base_idx: int):
    """Pass chunks through, recording each one's absolute end offset keyed by
    global chunk index — chunks from ``iter_chunks`` are contiguous consumed
    byte ranges, so the end offset is the running sum of lengths."""
    off = start_off
    for i, mv in enumerate(chunk_iter):
        off += len(mv)
        offsets[base_idx + i] = off
        yield mv


def run_wordcount_job(config: JobConfig, mapper: Mapper, reducer: Reducer,
                      workload: str = "wordcount") -> JobResult:
    """End-to-end word-count-shaped job (scalar values, string keys): split,
    map, fold on the device, read back, check conservation, write.

    With ``config.checkpoint_dir`` set, every mapped chunk is spilled
    atomically and a re-run replays the spilled prefix instead of re-mapping
    it (see :mod:`map_oxidize_tpu_torch.runtime.checkpoint`)."""
    config.validate()
    t_job = time.perf_counter()
    engine = make_engine(config, reducer, value_shape=mapper.value_shape,
                         value_dtype=mapper.value_dtype,
                         wide_keys=getattr(mapper, "wide_keys", False))
    dictionary = HashDictionary()
    records_in = 0
    n_chunks = 0

    def _ingest(out) -> None:
        nonlocal records_in, n_chunks
        dictionary.update(out.dictionary)
        records_in += out.records_in
        n_chunks += 1
        if mapper.keys_have_dictionary:
            # the dictionary covers every key fed so far, so its size bounds
            # distinct keys: growth needs no device sync
            engine.hint_total_keys(dictionary.upper_bound())
        engine.feed(out)

    t0 = time.perf_counter()
    # --- replay checkpointed chunks (resume), if any
    ckpt = None
    resume_k = 0      # chunks already mapped in a previous run
    resume_off = 0    # input byte offset where mapping resumes
    if config.checkpoint_dir:
        ckpt = CheckpointStore(config.checkpoint_dir,
                               CheckpointStore.job_meta(config, workload))
        for idx, out, next_off in ckpt.replay():
            _ingest(out)
            resume_k, resume_off = idx + 1, next_off
        if resume_k:
            _log.info("resumed %d checkpointed chunks%s", resume_k,
                      f" (input offset {resume_off})" if resume_off >= 0
                      else " (round-robin mode)")
        resume_off = max(resume_off, 0)  # -1 = round-robin: offsets unused

    # --- split (plan only; chunks stream lazily)
    native_file_iter = None
    offsets: dict[int, int] = {}  # global chunk idx -> end byte offset
    if config.num_chunks > 0:
        # round-robin compat mode: chunk identity is the index, not a byte
        # offset — resume skips the first resume_k chunks
        chunks = split_round_robin(config.input_path,
                                   config.num_chunks)[resume_k:]
    else:
        _, chunk_bytes = plan_chunks(config.input_path, config.chunk_bytes)
        # native mmap fast path: C++ scans page-cache pages in place (zero
        # kernel->user copies) and owns the chunk cuts; chunks map inline
        # in C++, so num_map_workers/max_retries do not apply (a map error
        # there is a hash collision or invalid UTF-8, which no retry fixes)
        if hasattr(mapper, "map_file"):
            native_file_iter = mapper.map_file(config.input_path,
                                               chunk_bytes, resume_off)
        if native_file_iter is None:
            chunks = _track_offsets(
                iter_chunks(config.input_path, chunk_bytes, resume_off),
                resume_off, offsets, resume_k)

    # --- map + reduce: the host half (C++ scan / Python map) runs in a
    # bounded prefetch thread, so chunk i+1's read+tokenize overlaps chunk
    # i's feed; order is preserved, so the spill and the output are
    # byte-identical to depth 1
    if native_file_iter is not None:
        it = pipelined(native_file_iter, config.pipeline_depth, name="map")
        for i, (out, next_off) in enumerate(it):
            _ingest(out)
            if ckpt is not None:
                ckpt.save(resume_k + i, out, next_off)
    else:
        for idx, out in run_map_phase(
                chunks, mapper, config.num_map_workers, config.max_retries,
                pipeline_depth=config.pipeline_depth):
            gidx = resume_k + idx
            _ingest(out)
            if ckpt is not None:
                ckpt.save(gidx, out, offsets.get(gidx, -1))
    t_map = time.perf_counter() - t0

    t0 = time.perf_counter()
    counts = _readback(engine, dictionary)
    top = counts.top_k(config.top_k)
    t_finalize = time.perf_counter() - t0

    # every token mapped lands in exactly one count (count-shaped sum
    # workloads only)
    if reducer.combine == "sum" and getattr(mapper, "conserves_counts", True):
        total = counts.total()
        if records_in and total != records_in:
            raise RuntimeError(
                f"count conservation violated: mapped {records_in} records "
                f"but reduced counts sum to {total}")

    t0 = time.perf_counter()
    if config.output_path:
        write_final_result(config.output_path, counts.items())
    t_write = time.perf_counter() - t0

    # keep_intermediates preserves the resumable spill
    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    acc_keys = engine.export_state()["acc_keys"]
    metrics = {
        "workload": workload,
        "accumulator_device": str(acc_keys.device),
        "capacity_rows": int(acc_keys.shape[0]),
        "records_in": records_in,
        "distinct_keys": len(counts),
        "chunks": n_chunks,
        "checkpoint/chunks_replayed": resume_k,
        "device_rows_fed": engine.rows_fed,
        "time/map+reduce_s": t_map,
        "time/finalize_s": t_finalize,
        "time/write_s": t_write,
        "time/job_s": time.perf_counter() - t_job,
    }
    if config.metrics:
        _log.info("metrics: %s", metrics)
    return JobResult(counts=counts, top=top, metrics=metrics)


@dataclass
class KMeansResult:
    centroids: np.ndarray
    metrics: dict = field(default_factory=dict)

    def top_report(self, k: int) -> str:  # CLI-facing summary
        return (f"k-means: {self.centroids.shape[0]} centroids, "
                f"dim {self.centroids.shape[1]}")


#: fit budget when the device reports no memory size (the CPU)
_KMEANS_DEVICE_FIT_BYTES = 8 << 30


def _kmeans_device_fit_bytes(config: JobConfig, device: torch.device) -> int:
    """``mapper='auto'`` takes the device-resident fit when the working set
    the JAX package budgets for — points plus ``(n, k)`` distance and
    one-hot intermediates, 4*n*(d + 2k) bytes — fits under this budget:
    ``config.kmeans_device_fit_bytes`` when set, else half the device's
    memory (``torch.cuda.mem_get_info``), else 8 GB."""
    if config.kmeans_device_fit_bytes:
        return config.kmeans_device_fit_bytes
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 2
    return _KMEANS_DEVICE_FIT_BYTES


def _adopt_checkpoint_kmeans_mode(config: JobConfig,
                                  meta_wo_mode: dict) -> str | None:
    """Best-effort read of an existing snapshot's ``kmeans_mode``.

    An ``auto`` resume must land on the mode its snapshot was cut from even
    if the auto heuristic would now choose another (a larger fit budget, a
    bigger card): otherwise the identity mismatch would silently discard
    training progress.  The stored mode is honoured only when every OTHER
    identity field matches (a stale foreign checkpoint must not flip a
    fresh job's mode)."""
    import json
    import os

    try:
        with open(os.path.join(config.checkpoint_dir, "meta.json")) as f:
            existing = json.load(f)
    except (OSError, ValueError):
        return None
    stored = existing.get("kmeans_mode")
    if stored not in ("device", "stream", "stream_device"):
        return None
    probe = {k: v for k, v in existing.items()
             if k not in ("kmeans_mode", "kmeans_shards", "version")}
    want = {k: v for k, v in meta_wo_mode.items()
            if k not in ("kmeans_mode", "kmeans_shards", "version")}
    return stored if probe == want else None


def run_kmeans_job(config: JobConfig,
                   centroids: np.ndarray | None = None) -> KMeansResult:
    """k-means over a ``.npy`` float32 ``(n, d)`` points file, in one of
    three modes (``kmeans_mode`` in the metrics and the checkpoint):

    * ``device`` (``mapper='device'``, and ``'auto'`` when the points fit):
      the points transfer once and every iteration runs on the device;
    * ``stream_device`` (``'auto'`` beyond the fit): every iteration
      streams the points through the device in chunks of
      ``chunk_bytes // (4 (d + 2k))`` rows;
    * ``stream`` (``mapper='native'`` or ``'python'``): every iteration
      assigns on the host in the prefetch thread, in chunks of
      ``chunk_bytes // (4 d)`` rows, and folds the per-chunk partial sums
      in the device reduce engine.

    The points file is memory-mapped.  Initial centroids default to the
    first ``kmeans_k`` points.

    With ``config.checkpoint_dir`` set, each iteration ends with one atomic
    snapshot of (centroids, iterations done); a re-run of the same job
    resumes from it, and an ``auto`` run takes the snapshot's mode.
    ``kmeans_iters`` is not identity: a snapshot at iteration i resumes any
    same-job run asking for >= i iterations, and one covering every
    requested iteration is the result.  A successful run deletes its
    snapshot unless ``keep_intermediates``."""
    from map_oxidize_tpu_torch.api import SumReducer
    from map_oxidize_tpu_torch.workloads import kmeans as km

    config.validate()
    if config.num_shards > 1:
        raise NotImplementedError(
            "sharded k-means is not ported yet (ROADMAP: sharded engines)")
    pts = np.load(config.input_path, mmap_mode="r")
    if pts.ndim != 2:
        raise ValueError(f"k-means input must be (n, d); got {pts.shape}")
    n, d = pts.shape
    if centroids is None:
        if n < config.kmeans_k:
            raise ValueError(
                f"k-means needs at least kmeans_k={config.kmeans_k} points "
                f"to init centroids; input has {n}")
        centroids = np.asarray(pts[:config.kmeans_k], np.float32)
    centroids = np.asarray(centroids, np.float32)
    device = pick_device(config.backend)
    # k, mode, shard count, backend and precision change the float
    # accumulation order, so they are identity; the digest pins the INITIAL
    # centroids, so a different init invalidates rather than being silently
    # overridden.  The keys are the JAX package's.
    identity = {
        "kmeans_k": config.kmeans_k,
        "kmeans_backend": config.backend,
        "kmeans_precision": config.kmeans_precision,
        "kmeans_init": hashlib.sha256(centroids.tobytes()).hexdigest()[:16],
    }
    if config.mapper == "device":
        mode = "device"
    elif config.mapper == "auto":
        # the working set the JAX package budgets for: points plus the
        # (n, k) distance and one-hot intermediates (the fused kernel never
        # allocates them; the formula is kept so that both packages pick
        # the same mode, and so the same checkpoint identity)
        fits = (4 * int(n) * (int(d) + 2 * config.kmeans_k)
                <= _kmeans_device_fit_bytes(config, device))
        mode = "device" if fits else "stream_device"
        if config.checkpoint_dir:
            # an existing snapshot's mode wins over the heuristic: resume
            # continues the trajectory it was cut from
            stored = _adopt_checkpoint_kmeans_mode(
                config, CheckpointStore.job_meta(config, "kmeans",
                                                 extra=identity))
            if stored is not None:
                mode = stored
    else:
        mode = "stream"

    # --- checkpoint/resume: the iteration boundary is k-means's natural
    # materialization barrier (centroids fully summarize progress)
    store = None
    start_iter = 0
    if config.checkpoint_dir:
        store = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, "kmeans", extra={
                **identity, "kmeans_mode": mode, "kmeans_shards": 1}))
        snap = store.load_snapshot()
        if snap is not None:
            state, _d, start_iter, _n, _x = snap
            centroids = np.asarray(state["centroids"], np.float32)
            _log.info("k-means resumed at iteration %d", start_iter)

    def _iter_done(i: int, c: np.ndarray) -> None:
        store.save_snapshot({"centroids": np.asarray(c, np.float32)},
                            HashDictionary(), start_iter + i, start_iter + i)

    on_iter = _iter_done if store is not None else None
    metrics: dict = {}
    remaining = config.kmeans_iters - start_iter
    if remaining < 0:
        # the snapshot already covers every requested iteration; its state
        # IS the result (use a fresh checkpoint_dir to recompute)
        _log.warning("checkpoint has %d iterations, more than the %d "
                     "requested; returning the snapshotted state",
                     start_iter, config.kmeans_iters)
    elif remaining > 0 and mode == "device":
        timings: dict = {}
        centroids = km.kmeans_fit_device(
            pts, centroids, iters=remaining, device=device, on_iter=on_iter,
            timings=timings, precision=config.kmeans_precision)
        metrics.update({f"time/{k}": v for k, v in timings.items()})
    elif remaining > 0 and mode == "stream_device":
        # the divisor budgets the per-chunk working set as the fit
        # heuristic does; chunking does not depend on dispatch_batch
        chunk_rows = max(1, config.chunk_bytes
                         // (4 * (int(d) + 2 * config.kmeans_k)))
        timings = {}
        centroids = km.kmeans_fit_streamed_device(
            config.input_path, centroids, iters=remaining,
            chunk_rows=chunk_rows, device=device,
            precision=config.kmeans_precision, timings=timings,
            on_iter=on_iter, pipeline_depth=config.pipeline_depth,
            dispatch_batch=config.dispatch_batch)
        metrics["time/feed_s"] = timings["feed_s"]
        metrics["dispatch/batch"] = timings["dispatch_batch"]
        if "overlap_ratio" in timings:
            metrics["pipeline/feed_wait_ms"] = timings["feed_wait_s"] * 1e3
            metrics["pipeline/overlap_ratio"] = timings["overlap_ratio"]
    elif remaining > 0:
        # the host assign (map_chunk) runs in the prefetch thread, so
        # assigning chunk i+1 overlaps chunk i's engine feed
        rows = max(1, config.chunk_bytes // (4 * d))
        pipe: dict = {}
        t0 = time.perf_counter()
        for it in range(start_iter, config.kmeans_iters):
            engine = make_engine(config, SumReducer(), value_shape=(d + 1,),
                                 value_dtype=np.float32)
            mapper = km.KMeansMapper(centroids)
            mapped = pipelined(
                (mapper.map_chunk(c) for c in
                 km.iter_point_chunks(config.input_path, rows)),
                config.pipeline_depth, name="kmeans/map", timings=pipe)
            centroids = km.kmeans_iteration(engine, centroids, (),
                                            mapper=mapper, mapped=mapped)
            if on_iter is not None:
                on_iter(it + 1 - start_iter, centroids)
        metrics["time/iter_s"] = time.perf_counter() - t0
        if pipe.get("produce_s"):
            metrics["pipeline/depth"] = config.pipeline_depth
            metrics["pipeline/produce_ms"] = pipe["produce_s"] * 1e3
            metrics["pipeline/feed_wait_ms"] = pipe["wait_s"] * 1e3
            metrics["pipeline/overlap_ratio"] = round(
                overlap_ratio(pipe["produce_s"], pipe["wait_s"]), 4)
    if config.output_path:
        km.write_centroids(config.output_path, centroids)
    ran_iters = max(remaining, 0)
    if store is not None:
        # a zero-work run (the snapshot already covered every requested
        # iteration) is a read of the continue-training state, not a
        # completion of it: deleting the snapshot would destroy it
        store.finish(config.keep_intermediates or ran_iters == 0)
    # records_in counts the work THIS run did: a resume ran only the
    # remaining iterations; ``iters`` is what the centroids represent
    metrics = {
        "workload": "kmeans",
        "kmeans_mode": mode,
        "kmeans_shards": 1,
        "device": str(device),
        "records_in": int(n) * ran_iters,
        "points": int(n),
        "dim": int(d),
        "iters": start_iter + ran_iters,
        **metrics,
    }
    if start_iter:
        metrics["resumed_iters"] = start_iter
    if config.metrics:
        _log.info("metrics: %s", metrics)
    return KMeansResult(centroids=centroids, metrics=metrics)
