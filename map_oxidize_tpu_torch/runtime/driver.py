"""Job drivers of the port: word count on one device, and the
device-resident k-means fit.

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
from map_oxidize_tpu_torch.runtime.pipeline import pipelined
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


def run_kmeans_job(config: JobConfig,
                   centroids: np.ndarray | None = None) -> KMeansResult:
    """k-means over a ``.npy`` float32 ``(n, d)`` points file, device-
    resident: the points transfer once and every iteration runs on the
    device.  Initial centroids default to the first ``kmeans_k`` points.
    The streamed paths (points beyond the fit, or a host mapper) are not
    ported yet and raise.

    With ``config.checkpoint_dir`` set, each iteration ends with one atomic
    snapshot of (centroids, iterations done); a re-run of the same job
    resumes from it.  ``kmeans_iters`` is not identity: a snapshot at
    iteration i resumes any same-job run asking for >= i iterations, and one
    covering every requested iteration is the result.  A successful run
    deletes its snapshot unless ``keep_intermediates``."""
    from map_oxidize_tpu_torch.workloads.kmeans import (
        kmeans_fit_device,
        write_centroids,
    )

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
    if config.mapper == "auto":
        fits = (4 * int(n) * (int(d) + 2 * config.kmeans_k)
                <= _kmeans_device_fit_bytes(config, device))
        if not fits:
            raise NotImplementedError(
                "points beyond the device fit need the streamed k-means, "
                "which is not ported yet (ROADMAP: streamed k-means)")
    elif config.mapper != "device":
        raise NotImplementedError(
            f"k-means mapper {config.mapper!r} (host-assign streaming) is "
            "not ported yet (ROADMAP: streamed k-means); use 'auto' or "
            "'device'")

    # --- checkpoint/resume: the iteration boundary is k-means's natural
    # materialization barrier (centroids fully summarize progress).  k,
    # mode, shard count, backend and precision change the float
    # accumulation order, so they are identity; the digest pins the INITIAL
    # centroids, so a different init invalidates rather than being silently
    # overridden.  The keys are the JAX package's.
    store = None
    start_iter = 0
    if config.checkpoint_dir:
        store = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, "kmeans", extra={
                "kmeans_k": config.kmeans_k,
                "kmeans_mode": "device",
                "kmeans_shards": 1,
                "kmeans_backend": config.backend,
                "kmeans_precision": config.kmeans_precision,
                "kmeans_init": hashlib.sha256(
                    centroids.tobytes()).hexdigest()[:16],
            }))
        snap = store.load_snapshot()
        if snap is not None:
            state, _d, start_iter, _n, _x = snap
            centroids = np.asarray(state["centroids"], np.float32)
            _log.info("k-means resumed at iteration %d", start_iter)

    def _iter_done(i: int, c: np.ndarray) -> None:
        store.save_snapshot({"centroids": np.asarray(c, np.float32)},
                            HashDictionary(), start_iter + i, start_iter + i)

    timings: dict = {}
    remaining = config.kmeans_iters - start_iter
    if remaining > 0:
        centroids = kmeans_fit_device(
            pts, centroids, iters=remaining, device=device,
            on_iter=_iter_done if store is not None else None,
            timings=timings, precision=config.kmeans_precision)
    elif remaining < 0:
        # the snapshot already covers every requested iteration; its state
        # IS the result (use a fresh checkpoint_dir to recompute)
        _log.warning("checkpoint has %d iterations, more than the %d "
                     "requested; returning the snapshotted state",
                     start_iter, config.kmeans_iters)
    if config.output_path:
        write_centroids(config.output_path, centroids)
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
        "kmeans_mode": "device",
        "device": str(device),
        "records_in": int(n) * ran_iters,
        "points": int(n),
        "dim": int(d),
        "iters": start_iter + ran_iters,
        **{f"time/{k}": v for k, v in timings.items()},
    }
    if start_iter:
        metrics["resumed_iters"] = start_iter
    if config.metrics:
        _log.info("metrics: %s", metrics)
    return KMeansResult(centroids=centroids, metrics=metrics)
