"""Job drivers of the port: word count and bigram (through the fold or the
collect reduce), the inverted index, distinct, and k-means in its three
modes (device-resident, streamed through the device, host-assign stream),
on one device or, with ``num_shards > 1``, on the sharded engines of
:mod:`map_oxidize_tpu_torch.parallel` (a mesh of device slots in one
process; :func:`effective_num_shards`).

The port of the JAX package's ``runtime/driver.py``.  The
map runs in a bounded prefetch thread (:mod:`~map_oxidize_tpu_torch.
runtime.pipeline`): the native C++ mmap scan, or the Python map through the
worker pool of :mod:`~map_oxidize_tpu_torch.runtime.executor`.  The
calling thread feeds the engine :func:`make_engine` picks — the device fold
(:class:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine`), or
for wide key spaces the host collect-reduce
(:class:`~map_oxidize_tpu_torch.runtime.host_reduce.HostCollectReduceEngine`)
behind a shuffle transport (:mod:`map_oxidize_tpu_torch.shuffle`); the
inverted index feeds the pair collect
(:class:`~map_oxidize_tpu_torch.runtime.collect.CollectEngine`), whose one
sort runs on the host or on the device.  With ``checkpoint_dir`` set, the
chunk-mapped jobs spill every mapped chunk and k-means snapshots every
iteration (:mod:`~map_oxidize_tpu_torch.runtime.checkpoint`); a re-run
resumes.  Every job records into one ``Obs`` bundle
(:mod:`map_oxidize_tpu_torch.obs`): phases, counters, the wall
attribution, the data-plane audit, and the flight recorder around the
body.
"""

from __future__ import annotations

import hashlib
import time
from collections.abc import ItemsView, Mapping
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from map_oxidize_tpu_torch.api import Mapper, Reducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.splitter import (
    iter_chunks,
    iter_doc_chunks,
    plan_chunks,
    split_round_robin,
)
from map_oxidize_tpu_torch.io.writer import (
    format_top_words,
    write_final_result,
    write_postings,
)
from map_oxidize_tpu_torch.obs import Obs, observe_device_wait
from map_oxidize_tpu_torch.obs.dataplane import map_output_rows
from map_oxidize_tpu_torch.ops.hashing import SENTINEL, HashDictionary, join_u64
from map_oxidize_tpu_torch.ops.topk import top_k_candidate_indices
from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
from map_oxidize_tpu_torch.runtime.device_dict import NativeDictionary
from map_oxidize_tpu_torch.runtime.engine import (
    DeviceReduceEngine,
    StreamingEngineBase,
    pick_device,
)
from map_oxidize_tpu_torch.runtime.executor import run_map_phase
from map_oxidize_tpu_torch.runtime.pipeline import pipelined
from map_oxidize_tpu_torch.shuffle.base import resolve_transport
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


@dataclass
class JobResult:
    """``final_result.txt``'s counts, the top-k and metrics.  ``counts`` is
    a read-only Mapping (:class:`LazyCounts`)."""

    counts: "Mapping[bytes, int]"
    top: list[tuple[bytes, int]]
    metrics: dict = field(default_factory=dict)
    #: Chrome trace events when the job traced (``trace_out``), else None
    trace: list | None = None

    def top_report(self, k: int) -> str:
        return format_top_words(self.top, k)


def effective_num_shards(config: JobConfig) -> int:
    """``num_shards`` with 0 resolved to the backend's real pool (JAX
    ``runtime/driver.py:51``): every CUDA card, or the one CPU device; 1
    when the pool is empty, so a ``cuda`` job without a card reaches the
    one-device path and its named error.  The one answer every caller
    that must agree with the engine built reads.  Under a process group
    of P processes the pool is global: P times the local pool."""
    from map_oxidize_tpu_torch.parallel.mesh import process_slot, real_pool

    n = config.num_shards
    if n == 0:
        n = max(len(real_pool(config.backend)), 1) * process_slot()[1]
    return n


def solved_exchange(config: JobConfig, obs: Obs) -> str:
    """The planner's ``exchange_collective`` knob (a pin is echoed
    verbatim) as a concrete wire program, with the ``all_to_all`` default
    when no plan resolved one (JAX ``runtime/driver.py:85``)."""
    method = obs.knob("exchange_collective", config.exchange_collective)
    return "all_to_all" if method in (None, "", "auto") else str(method)


def collect_engine_kw(config: JobConfig) -> dict:
    """Constructor kwargs shared by every collect-engine site (JAX
    ``runtime/driver.py:66``): 0 means 'engine default', so the key is
    passed only when set."""
    return ({"max_rows": config.collect_max_rows}
            if config.collect_max_rows else {})


def solved_transport(config: JobConfig, obs: Obs) -> str:
    """The planner's ``shuffle_transport`` knob (``Obs.knob``; a pin is
    echoed verbatim) resolved to a concrete transport name through the
    same router the engines use (JAX ``runtime/driver.py:73``), so the
    driver's cadence decisions (push pipelining, map-side combining) and
    the engine's placement agree."""
    cap = int(config.collect_max_rows or 0) or (1 << 27)
    return resolve_transport(config, cap,
                             name=obs.knob("shuffle_transport",
                                           config.shuffle_transport))


def make_engine(config: JobConfig, reducer, value_shape=(),
                value_dtype=np.int32, wide_keys: bool = False,
                transport: str | None = None,
                exchange_method: str = "all_to_all"):
    """Pick the engine (JAX ``runtime/driver.py:95-133``): the shard count
    selects one device or the sharded fold over the mesh, and
    ``reduce_mode`` (or the mapper's ``wide_keys`` declaration under
    'auto') selects the streaming device fold or the host collect-reduce
    for wide key spaces (one device only: the sharded engine
    hash-partitions the key space, so each shard stays narrow); vector
    values always fold."""
    n = effective_num_shards(config)
    mode = config.reduce_mode
    if mode == "auto":
        mode = ("collect" if wide_keys and n <= 1
                and tuple(value_shape) == () else "fold")
    elif mode == "collect" and tuple(value_shape) != ():
        _log.info("reduce_mode='collect' takes scalar values only; the "
                  "vector-valued reduce uses the fold engine")
        mode = "fold"
    if mode == "collect" and n > 1:
        _log.info("reduce_mode='collect' is single-device; the %d-shard "
                  "mesh engine hash-partitions instead", n)
    elif mode == "collect":
        from map_oxidize_tpu_torch.runtime.host_reduce import (
            HostCollectReduceEngine,
        )

        return HostCollectReduceEngine(config, reducer,
                                       value_shape=value_shape,
                                       value_dtype=value_dtype,
                                       transport=transport,
                                       **collect_engine_kw(config))
    if n <= 1:
        return DeviceReduceEngine(config, reducer, value_shape=value_shape,
                                  value_dtype=value_dtype)
    from map_oxidize_tpu_torch.parallel.engine import ShardedReduceEngine

    return ShardedReduceEngine(config, reducer, value_shape=value_shape,
                               value_dtype=value_dtype,
                               exchange_method=exchange_method)


class LazyCounts(Mapping):
    """{word_bytes: count} view over the engine's columnar readback.

    The total, the distinct-key count and the top-k are answered from the
    hash/value ARRAYS plus at most k string lookups; the real dict is
    materialized only when a consumer needs strings for every key
    (iteration, dict comparisons, final_result.txt over a Python
    dictionary; over a :class:`NativeDictionary` the file is written
    natively, :class:`CountItems`)."""

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
        prefetch = getattr(self._dict, "prefetch", None)
        if prefetch is not None:  # hash-only mode: batch-resolve winners
            prefetch(self._k64[cand])
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
            prefetch = getattr(self._dict, "prefetch", None)
            if prefetch is not None:  # hash-only mode: one resolve-all scan
                prefetch(self._k64)
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

    def items(self) -> "CountItems":
        return CountItems(self)


class CountItems(ItemsView):
    """``LazyCounts.items()``.  Iterating it materializes the counts, so
    ``sorted``, ``dict`` and comparisons see the pairs they always saw.
    Over a :class:`NativeDictionary` and integer counts, ``write_native``
    writes ``final_result.txt``'s rows to an open file descriptor in one
    native call (:meth:`NativeDictionary.write_counts`), which
    :func:`write_final_result` takes; elsewhere it is None."""

    def __init__(self, counts: LazyCounts):
        super().__init__(counts)
        d, vals = counts._dict, counts._vals
        self.write_native = (
            partial(d.write_counts, counts._k64, vals)
            if isinstance(d, NativeDictionary) and vals.ndim == 1
            and np.can_cast(vals.dtype, np.int64) else None)

    def __iter__(self):
        return iter(self._mapping._materialize().items())


def _readback(engine: StreamingEngineBase, dictionary: HashDictionary
              ) -> LazyCounts:
    """Device accumulator -> :class:`LazyCounts`.  Padding rows carry the
    SENTINEL key, so mask."""
    hi, lo, vals, n = engine.finalize()
    if getattr(engine, "device", None) is None:
        # the host collect's result is already host arrays; its (empty)
        # fetch is timed all the same, as the JAX package's readback does,
        # while a device engine times its one fetch inside finalize
        observe_device_wait(time.perf_counter())
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
                      workload: str = "wordcount", on_obs=None) -> JobResult:
    """End-to-end word-count-shaped job (scalar values, string keys): split,
    map, fold on the device, read back, audit conservation, write.

    With ``config.checkpoint_dir`` set, every mapped chunk is spilled
    atomically and a re-run replays the spilled prefix instead of re-mapping
    it (see :mod:`map_oxidize_tpu_torch.runtime.checkpoint`).

    The body runs in the job's ``Obs`` envelope (``Obs.recording``): the
    phases ``replay``, ``split``, ``map+reduce``, ``finalize`` and
    ``write`` (JAX ``runtime/driver.py:419-516``), and any abort passes
    through the flight recorder before it propagates.  ``on_obs`` receives
    the bundle before the body starts."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, workload):
        return _run_wordcount_body(config, obs, mapper, reducer, workload)


def _run_wordcount_body(config: JobConfig, obs: Obs, mapper: Mapper,
                        reducer: Reducer, workload: str) -> JobResult:
    from map_oxidize_tpu_torch.runtime.host_reduce import (
        HostCollectReduceEngine,
    )
    from map_oxidize_tpu_torch.shuffle.pipelined import (
        COMBINABLE,
        combine_map_output,
        record_push_combine,
    )

    metrics = obs.registry
    # the shuffle transport (JAX runtime/driver.py:322-341): 'pipelined'
    # turns on the push cadence — the map runs ahead under the push/* span
    # names with the overlap gauge, and the map-side combiner collapses
    # each push window before the feed
    transport = solved_transport(config, obs)
    push_mode = transport == "pipelined"
    engine = make_engine(config, reducer, value_shape=mapper.value_shape,
                         value_dtype=mapper.value_dtype,
                         wide_keys=getattr(mapper, "wide_keys", False),
                         transport=transport,
                         exchange_method=solved_exchange(config, obs))
    engine.obs = obs
    collect = isinstance(engine, HostCollectReduceEngine)
    if collect:
        # the host collect touches no device, but the job still runs on
        # the backend it asked for: a missing card raises here too
        pick_device(config.backend)
        metrics.set("shuffle/transport", engine.transport)
    elif push_mode:
        metrics.set("shuffle/transport", "pipelined")
    do_combine = (config.push_combine != "off"
                  and (config.push_combine == "on" or push_mode)
                  and reducer.combine in COMBINABLE)
    # the data-plane audit over the engine's hash partitions (virtual ones
    # on one device): conservation, skew, reduction
    dp = obs.ensure_dataplane(
        engine.S, conserves=(reducer.combine == "sum"
                             and getattr(mapper, "conserves_counts", True)))

    # hash-only map (JAX runtime/driver.py:351-372): with the host collect
    # the map needs neither per-chunk combining nor key strings (the one
    # final sort dedups; strings resolve later by a same-cuts rescan,
    # RescanDictionary).  Only the byte-range mmap path qualifies —
    # round-robin chunking has no byte cuts for the rescan to replay.
    hash_only = (getattr(mapper, "supports_hash_only", False)
                 and config.num_chunks == 0 and collect)
    if hasattr(mapper, "hash_only"):
        # assign both ways: a mapper reused across jobs must not keep a
        # stale True from an earlier collect run
        mapper.hash_only = hash_only
    if hash_only:
        _, rb_chunk = plan_chunks(config.input_path, config.chunk_bytes)
        dictionary = mapper.rescan_dictionary(
            config.input_path, rb_chunk, early_stop=not config.rescan_full)
    else:
        dictionary = HashDictionary()
    records_in = 0
    n_chunks = 0

    def _ingest(out, next_off: int | None = None) -> None:
        nonlocal records_in, n_chunks
        dictionary.update(out.dictionary)
        records_in += out.records_in
        n_chunks += 1
        if dp is not None and len(out):
            rows = map_output_rows(out)
            if rows is not None:
                dp.record_fold_in(*rows)
        if do_combine and len(out):
            # map-side combine AFTER the audit digested the raw rows: the
            # weighted checksum is sum-combine-invariant, so the verdict
            # is unchanged while the feed shrinks
            out, c_in, c_out = combine_map_output(out, reducer.combine)
            record_push_combine(obs, c_in, c_out)
        if mapper.keys_have_dictionary:
            # the dictionary covers every key fed so far, so its size bounds
            # distinct keys: growth needs no device sync
            engine.hint_total_keys(dictionary.upper_bound())
        t0 = time.perf_counter()
        with obs.feed_span(rows=len(out)):
            engine.feed(out)
        metrics.observe("feed_block_ms", (time.perf_counter() - t0) * 1e3)
        if obs.heartbeat is not None:
            obs.heartbeat.update(rows=out.records_in, bytes_done=next_off)

    # --- replay checkpointed chunks (resume), if any
    ckpt = None
    resume_k = 0      # chunks already mapped in a previous run
    resume_off = 0    # input byte offset where mapping resumes
    if config.checkpoint_dir:
        ckpt = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, workload, hash_only=hash_only),
            registry=metrics)
        with obs.phase("replay"):
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
    with obs.phase("split"):
        if config.num_chunks > 0:
            # round-robin compat mode: chunk identity is the index, not a
            # byte offset — resume skips the first resume_k chunks
            chunks = split_round_robin(config.input_path,
                                       config.num_chunks)[resume_k:]
        else:
            _, chunk_bytes = plan_chunks(config.input_path,
                                         config.chunk_bytes)
            # native mmap fast path: C++ scans page-cache pages in place
            # and owns the chunk cuts; chunks map inline in C++, so
            # num_map_workers/max_retries do not apply
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
    with obs.phase("map+reduce"):
        depth = obs.knob("pipeline_depth", config.pipeline_depth)
        if push_mode:
            # the push cadence needs a producer running ahead: depth >= 2,
            # push/* span names and the shuffle overlap gauge
            depth = max(2, depth)
        if native_file_iter is not None:
            it = pipelined(native_file_iter, depth, obs,
                           name="push" if push_mode else "map",
                           ratio_gauge=("pipeline/shuffle_overlap_ratio"
                                        if push_mode else None))
            for i, (out, next_off) in enumerate(it):
                _ingest(out, next_off)
                if ckpt is not None:
                    ckpt.save(resume_k + i, out, next_off)
        else:
            for idx, out in run_map_phase(
                    chunks, mapper, config.num_map_workers,
                    config.max_retries, pipeline_depth=depth, obs=obs):
                gidx = resume_k + idx
                _ingest(out, offsets.get(gidx))
                if ckpt is not None:
                    ckpt.save(gidx, out, offsets.get(gidx, -1))

    # --- finalize on the device; the fetch is device/compute_ms
    with obs.phase("finalize"):
        counts = _readback(engine, dictionary)
        top = counts.top_k(config.top_k)

    # conservation audit: every token mapped lands in exactly one count,
    # per hash partition, with matching order-independent checksums (count-
    # shaped sum workloads only; conserves=False skips it)
    if dp is not None:
        dp.set_records_in(records_in)
        dp.record_fold_out(counts._k64, counts._vals)
        dp.resolve_hot_keys(dictionary.lookup)
        dp.check_fold()
        dp.check_total(counts.total())
    elif (reducer.combine == "sum"
          and getattr(mapper, "conserves_counts", True)):
        total = counts.total()
        if records_in and total != records_in:
            raise RuntimeError(
                f"count conservation violated: mapped {records_in} records "
                f"but reduced counts sum to {total}")

    return _finish_wordcount(
        config, obs, workload, counts, top, ckpt, records_in, n_chunks,
        "host" if collect else str(engine.device),
        device_rows_fed=engine.rows_fed)


def _finish_wordcount(config: JobConfig, obs: Obs, workload: str,
                      counts: LazyCounts, top: list, ckpt, records_in: int,
                      n_chunks: int, accumulator_device: str, write=None,
                      **gauges) -> JobResult:
    """The tail of the word-count and bigram jobs (the host map's and the
    device map's): the ``write`` phase (``final_result.txt`` from
    ``counts`` by ``write``, default :func:`write_final_result`), the
    checkpoint's end, the job's gauges (the caller's own ``gauges`` among
    them), ``obs.finish`` and the result."""
    metrics = obs.registry
    with obs.phase("write"):
        if config.output_path:
            (write or write_final_result)(config.output_path,
                                          counts.items())

    # keep_intermediates preserves the resumable spill or snapshot
    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    metrics.set("records_in", records_in)
    metrics.set("distinct_keys", len(counts))
    metrics.set("chunks", n_chunks)
    for name, value in gauges.items():
        metrics.set(name, value)
    # the port's own: where the reduce ran (nothing falls back)
    metrics.set("accumulator_device", accumulator_device)
    summary, trace = obs.finish(config, workload)
    result = JobResult(counts=counts, top=top, metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


@dataclass
class InvertedIndexResult:
    """Postings plus metrics (JAX ``runtime/driver.py:537``).
    ``postings`` is a read-only Mapping (:class:`Postings`): CSR-backed,
    materializing per-term doc lists only on access."""

    postings: "Mapping[bytes, list[int]]"
    metrics: dict = field(default_factory=dict)
    trace: list | None = None

    def top_report(self, k: int) -> str:
        top = self.postings.top_by_df(k)
        lines = [f"Top {k} terms by document frequency:"]
        lines += [f"{t.decode('utf-8', 'replace')}: {df} docs"
                  for t, df in top]
        return "\n".join(lines)


def run_inverted_index_job(config: JobConfig, on_obs=None
                           ) -> InvertedIndexResult:
    """Inverted-index build (JAX ``runtime/driver.py:558``): the map emits
    one (term, doc) pair per distinct term per document; the
    :class:`~map_oxidize_tpu_torch.runtime.collect.CollectEngine` sorts all
    pairs once (on the host, or on the device under
    ``collect_sort='device'``); postings fall out as contiguous segments.

    Output file: one line per term, ``term\\td1 d2 d3...``, terms in byte
    order."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "invertedindex"):
        return _run_inverted_index_body(config, obs)


def _run_inverted_index_body(config: JobConfig, obs: Obs
                             ) -> InvertedIndexResult:
    from map_oxidize_tpu_torch.runtime.collect import CollectEngine
    from map_oxidize_tpu_torch.workloads.inverted_index import (
        Postings,
        make_inverted_index,
        postings_from_sorted,
    )

    metrics = obs.registry
    mapper = make_inverted_index(config.tokenizer, config.use_native)
    transport = solved_transport(config, obs)
    push_mode = transport == "pipelined"
    if effective_num_shards(config) > 1:
        from map_oxidize_tpu_torch.parallel.collect import (
            ShardedCollectEngine,
        )

        if config.collect_sort != "auto":
            _log.info("collect_sort=%r applies to the single-device "
                      "engine only; the sharded path sorts per shard on "
                      "the device", config.collect_sort)
        engine = ShardedCollectEngine(
            config, transport=transport,
            exchange_method=solved_exchange(config, obs),
            **collect_engine_kw(config))
    else:
        engine = CollectEngine(config, transport=transport,
                               **collect_engine_kw(config))
        if engine.device is None:
            # a host sort touches no device, but the job still runs on
            # the backend it asked for: a missing card raises here too
            pick_device(config.backend)
    engine.obs = obs
    metrics.set("shuffle/transport", engine.transport)
    # data-plane audit: (term, doc) pairs must cross the collect shuffle
    # (and any spill round-trip) as an unchanged multiset
    dp = obs.ensure_dataplane(engine.S)
    dictionary = HashDictionary()
    records_in = 0
    n_chunks = 0

    def _ingest(out, next_off: int | None = None) -> None:
        nonlocal records_in, n_chunks
        dictionary.update(out.dictionary)
        records_in += out.records_in
        n_chunks += 1
        if dp is not None and len(out):
            dp.record_pairs_in(*map_output_rows(out, pairs=True))
        t0 = time.perf_counter()
        with obs.feed_span(rows=len(out)):
            engine.feed(out)
        metrics.observe("feed_block_ms", (time.perf_counter() - t0) * 1e3)
        if obs.heartbeat is not None:
            obs.heartbeat.update(rows=out.records_in, bytes_done=next_off)

    # --- replay checkpointed chunks (resume): the collect feed is
    # append-only, so per-chunk spill + replay maps like word count's
    ckpt = None
    resume_k = 0
    resume_off = 0
    if config.checkpoint_dir:
        ckpt = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, "invertedindex"),
            registry=metrics)
        with obs.phase("replay"):
            for idx, out, next_off in ckpt.replay():
                _ingest(out)
                resume_k, resume_off = idx + 1, next_off
        if resume_k:
            _log.info("resumed %d checkpointed chunks (input offset %d)",
                      resume_k, resume_off)

    with obs.phase("map+collect"):
        _, chunk_bytes = plan_chunks(config.input_path, config.chunk_bytes)
        it = mapper.iter_file_docs(config.input_path, chunk_bytes, resume_off)
        if it is None:
            def _host_iter():
                off = resume_off
                for chunk in iter_doc_chunks(config.input_path, chunk_bytes,
                                             resume_off):
                    off += len(chunk)
                    yield mapper.map_docs(chunk, off - len(chunk)), off
            it = _host_iter()
        # prefetch: doc-chunk read+tokenize overlaps the collect feed
        depth = obs.knob("pipeline_depth", config.pipeline_depth)
        if push_mode:
            depth = max(2, depth)
        it = pipelined(it, depth, obs,
                       name="push" if push_mode else "map",
                       ratio_gauge=("pipeline/shuffle_overlap_ratio"
                                    if push_mode else None))
        for i, (out, next_off) in enumerate(it):
            _ingest(out, next_off)
            if ckpt is not None:
                ckpt.save(resume_k + i, out, next_off)

    with obs.phase("sort+postings"):
        if engine.spilled:
            # beyond-RAM run: bucket-by-bucket CSR with an on-disk doc
            # column (memmap); Postings answers everything lazily
            terms, offsets, docs, holder = engine.finalize_spilled_csr()
            postings = Postings(terms, offsets, docs, dictionary)
            postings._spill_holder = holder  # keeps the doc file alive
            metrics.set("spilled_pairs", int(engine.spilled_rows))
            metrics.set("grouped_finalize", False)
        else:
            # the map-phase dictionary enumerates every distinct term, so
            # the host finalize can GROUP instead of SORT
            # (engine.finalize_csr); the device sort keeps the
            # sorted-pairs path
            csr = None
            if (engine.sort_mode == "host"
                    and config.use_native
                    and len(dictionary) <= max(engine.rows_fed // 8, 1)):
                d = dictionary.materialized()
                uniq = np.sort(np.fromiter(d.keys(), np.uint64,
                                           count=len(d)))
                csr = engine.finalize_csr(uniq)
            if csr is not None:
                postings = Postings(*csr, dictionary)
                if dp is not None:
                    # expand the CSR back to per-pair keys: grouping must
                    # not have dropped or invented a single (term, doc)
                    dp.record_pairs_out(
                        np.repeat(csr[0], np.diff(csr[1])), csr[2])
            else:
                keys, docs = engine.finalize()
                postings = postings_from_sorted(keys, docs, dictionary)
                if dp is not None:
                    dp.record_pairs_out(keys, docs)
            metrics.set("grouped_finalize", csr is not None)
    if dp is not None:
        dp.set_records_in(records_in)
        dp.resolve_hot_keys(dictionary.lookup)
        dp.check_pairs()

    return _finish_inverted_index(config, obs, postings, ckpt,
                                  records_in, n_chunks)


def _finish_inverted_index(config, obs, postings, ckpt, records_in,
                           n_chunks) -> InvertedIndexResult:
    """The inverted index's tail (JAX ``runtime/driver.py:726``): write,
    checkpoint cleanup, metrics, result."""
    metrics = obs.registry
    with obs.phase("write"):
        if config.output_path:
            write_postings(config.output_path, postings)

    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    metrics.set("records_in", records_in)
    metrics.set("pairs", int(postings.n_pairs))
    metrics.set("distinct_terms", len(postings))
    metrics.set("chunks", n_chunks)
    summary, trace = obs.finish(config, "invertedindex")
    result = InvertedIndexResult(postings=postings, metrics=summary,
                                 trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


@dataclass
class KMeansResult:
    centroids: np.ndarray
    metrics: dict = field(default_factory=dict)
    trace: list | None = None

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


def run_kmeans_job(config: JobConfig, centroids: np.ndarray | None = None,
                   on_obs=None) -> KMeansResult:
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
    snapshot unless ``keep_intermediates``.

    The body runs in the job's ``Obs`` envelope with the phases
    ``iterate`` and ``write``; ``device/compute_ms`` times the blocking
    centroid fetches (per-iteration snapshot and the final force)."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "kmeans"):
        return _run_kmeans_body(config, obs, centroids)


def _run_kmeans_body(config: JobConfig, obs: Obs,
                     centroids: np.ndarray | None) -> KMeansResult:
    from map_oxidize_tpu_torch.api import SumReducer
    from map_oxidize_tpu_torch.workloads import kmeans as km

    metrics = obs.registry
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
    # the device fits split the points (or each streamed chunk) over the
    # mesh: the shard count changes the float accumulation order, so it is
    # checkpoint identity (JAX runtime/driver.py:908-914)
    n_shards = (effective_num_shards(config)
                if mode in ("device", "stream_device") else 1)
    metrics.set("kmeans_mode", mode)
    metrics.set("kmeans_shards", n_shards)

    # --- checkpoint/resume: the iteration boundary is k-means's natural
    # materialization barrier (centroids fully summarize progress)
    store = None
    start_iter = 0
    if config.checkpoint_dir:
        store = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, "kmeans", extra={
                **identity, "kmeans_mode": mode,
                "kmeans_shards": n_shards}))
        snap = store.load_snapshot()
        if snap is not None:
            state, _d, start_iter, _n, _x = snap
            centroids = np.asarray(state["centroids"], np.float32)
            _log.info("k-means resumed at iteration %d", start_iter)

    def _iter_done(i: int, c: np.ndarray | None = None) -> None:
        """Per-iteration hook of every mode: heartbeat tick (iteration
        fraction) and the snapshot.  Passed only when one of them exists:
        it costs a centroid fetch per iteration."""
        if obs.heartbeat is not None:
            obs.heartbeat.update(
                rows=int(n),
                fraction=min((start_iter + i) / config.kmeans_iters, 1.0))
        if store is not None and c is not None:
            store.save_snapshot({"centroids": np.asarray(c, np.float32)},
                                HashDictionary(), start_iter + i,
                                start_iter + i)

    on_iter = (_iter_done if store is not None or obs.heartbeat is not None
               else None)
    remaining = config.kmeans_iters - start_iter
    with obs.phase("iterate"):
        if remaining < 0:
            # the snapshot already covers every requested iteration; its
            # state IS the result (use a fresh checkpoint_dir to recompute)
            _log.warning("checkpoint has %d iterations, more than the %d "
                         "requested; returning the snapshotted state",
                         start_iter, config.kmeans_iters)
        elif remaining > 0 and mode == "device":
            timings: dict = {}
            if n_shards > 1:
                from map_oxidize_tpu_torch.parallel.kmeans import (
                    kmeans_fit_sharded,
                )

                centroids = kmeans_fit_sharded(
                    pts, centroids, iters=remaining,
                    num_shards=config.num_shards, backend=config.backend,
                    on_iter=on_iter, timings=timings,
                    precision=config.kmeans_precision)
            else:
                centroids = km.kmeans_fit_device(
                    pts, centroids, iters=remaining,
                    device=pick_device(config.backend), on_iter=on_iter,
                    timings=timings, precision=config.kmeans_precision)
            for tk, tv in timings.items():
                metrics.set(f"time/{tk}", round(tv, 4))
        elif remaining > 0 and mode == "stream_device":
            # the divisor budgets the per-chunk working set as the fit
            # heuristic does; chunking does not depend on dispatch_batch
            chunk_rows = max(1, config.chunk_bytes
                             // (4 * (int(d) + 2 * config.kmeans_k)))
            timings = {}
            kw = dict(iters=remaining, chunk_rows=chunk_rows,
                      precision=config.kmeans_precision, timings=timings,
                      on_iter=on_iter,
                      pipeline_depth=obs.knob("pipeline_depth",
                                              config.pipeline_depth),
                      dispatch_batch=config.dispatch_batch)
            if n_shards > 1:
                # streaming x sharding: each chunk splits over the mesh
                from map_oxidize_tpu_torch.parallel.kmeans import (
                    kmeans_fit_streamed,
                )

                centroids = kmeans_fit_streamed(
                    config.input_path, centroids,
                    num_shards=config.num_shards, backend=config.backend,
                    **kw)
            else:
                centroids = km.kmeans_fit_streamed_device(
                    config.input_path, centroids,
                    device=pick_device(config.backend), **kw)
            # B and its inputs are already the dispatch/* gauges
            metrics.set("time/feed_s", round(timings["feed_s"], 4))
            if "overlap_ratio" in timings:
                # the stager live-fed pipeline/feed_wait_ms per block
                metrics.set("pipeline/overlap_ratio",
                            timings["overlap_ratio"])
        elif remaining > 0:
            # the host assign (map_chunk) runs in the prefetch thread, so
            # assigning chunk i+1 overlaps chunk i's engine feed
            rows = max(1, config.chunk_bytes // (4 * d))
            for it in range(start_iter, config.kmeans_iters):
                engine = make_engine(config, SumReducer(),
                                     value_shape=(d + 1,),
                                     value_dtype=np.float32)
                mapper = km.KMeansMapper(centroids)
                mapped = pipelined(
                    (mapper.map_chunk(c) for c in
                     km.iter_point_chunks(config.input_path, rows)),
                    obs.knob("pipeline_depth", config.pipeline_depth), obs,
                    name="kmeans/map")
                centroids = km.kmeans_iteration(engine, centroids, (),
                                                mapper=mapper, mapped=mapped)
                if on_iter is not None:
                    on_iter(it + 1 - start_iter,
                            centroids if store is not None else None)
    with obs.phase("write"):
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
    metrics.set("records_in", int(n) * ran_iters)
    metrics.set("points", int(n))
    metrics.set("dim", int(d))
    metrics.set("iters", start_iter + ran_iters)
    if start_iter:
        metrics.set("resumed_iters", start_iter)
    # the port's own: where the fit ran (nothing falls back)
    metrics.set("device", str(device))
    summary, trace = obs.finish(config, "kmeans")
    result = KMeansResult(centroids=centroids, metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


@dataclass
class DistinctResult:
    """HyperLogLog estimate plus the register state and metrics (JAX
    ``runtime/driver.py:1128``).  ``registers`` is the dense ``(2^p,)``
    int32 array (mergeable: max with another run's registers estimates
    the union's cardinality)."""

    estimate: float
    registers: np.ndarray
    metrics: dict = field(default_factory=dict)
    trace: list | None = None

    def top_report(self, k: int) -> str:  # CLI-facing summary
        filled = int(np.count_nonzero(self.registers))
        return (f"distinct tokens ~ {self.estimate:,.0f}  "
                f"(HLL p={int(np.log2(self.registers.shape[0]))}, "
                f"{filled}/{self.registers.shape[0]} registers filled, "
                f"rse ~{104 / np.sqrt(self.registers.shape[0]):.2f}%)")


def run_distinct_job(config: JobConfig, on_obs=None) -> DistinctResult:
    """Approximate distinct-token count (HyperLogLog; JAX
    ``runtime/driver.py:1146-1291``): a max-monoid fold over ``2^p``
    integer-keyed registers.  On one device the (bucket, max-rank) rows
    fold straight into a dense host register array, as in the JAX
    package: 2^p int32 is ~64KB at p=14, each chunk's fold is
    microseconds, and a device accumulator would cost a copy per chunk
    plus a finalize fetch."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "distinct"):
        return _run_distinct_body(config, obs)


def _run_distinct_body(config: JobConfig, obs: Obs) -> DistinctResult:
    from map_oxidize_tpu_torch import runtime as _rt
    from map_oxidize_tpu_torch.workloads.distinct import (
        DistinctMapper,
        hll_estimate,
        write_distinct_output,
    )

    from map_oxidize_tpu_torch.api import MaxReducer

    metrics = obs.registry
    p = config.hll_precision
    m = 1 << p
    use_native = _rt.resolve_mapper(config, "distinct") == "native"
    mapper = DistinctMapper(config.tokenizer, use_native, p)
    # one shard: the (bucket, max-rank) rows fold straight into a dense
    # host register array.  The sharded engine keeps the device fold
    # (JAX runtime/driver.py:1181-1186)
    engine = None
    host_regs = np.zeros(m, np.int32)
    if effective_num_shards(config) > 1:
        engine = make_engine(config, MaxReducer(), value_shape=(),
                             value_dtype=np.int32)
        engine.obs = obs
        engine.hint_total_keys(m)
    else:
        # the fold is host-side, but the job runs on the backend it
        # asked for: a missing card raises here too
        pick_device(config.backend)
    records_in = 0
    n_chunks = 0

    def _ingest(out, next_off: int | None = None) -> None:
        nonlocal records_in, n_chunks
        records_in += out.records_in
        n_chunks += 1
        t0 = time.perf_counter()
        if engine is not None:
            with obs.feed_span(rows=len(out)):
                engine.feed(out)
        else:
            # lo is flatnonzero output — unique per chunk, so fancy-index
            # max is exact
            idx = out.lo.astype(np.int64)
            host_regs[idx] = np.maximum(host_regs[idx], out.values)
        metrics.observe("feed_block_ms", (time.perf_counter() - t0) * 1e3)
        if obs.heartbeat is not None:
            obs.heartbeat.update(rows=out.records_in, bytes_done=next_off)

    # --- replay checkpointed chunks (resume): registers are ordinary
    # (key, value) rows, so the standard per-chunk spill applies
    ckpt = None
    resume_k = 0
    resume_off = 0
    if config.checkpoint_dir:
        ckpt = CheckpointStore(
            config.checkpoint_dir,
            CheckpointStore.job_meta(config, "distinct",
                                     extra={"hll_precision": p}),
            registry=metrics)
        with obs.phase("replay"):
            for idx, out, next_off in ckpt.replay():
                _ingest(out)
                resume_k, resume_off = idx + 1, next_off

    with obs.phase("split"):
        _, chunk_bytes = plan_chunks(config.input_path, config.chunk_bytes)
        file_iter = mapper.map_file(config.input_path, chunk_bytes,
                                    resume_off)
        if file_iter is None:
            offsets: dict[int, int] = {}
            chunks = _track_offsets(
                iter_chunks(config.input_path, chunk_bytes, resume_off),
                resume_off, offsets, resume_k)

    with obs.phase("map+reduce"):
        if file_iter is not None:
            it = pipelined(file_iter,
                           obs.knob("pipeline_depth", config.pipeline_depth),
                           obs, name="map")
            for i, (out, next_off) in enumerate(it):
                _ingest(out, next_off)
                if ckpt is not None:
                    ckpt.save(resume_k + i, out, next_off)
        else:
            for idx, out in run_map_phase(
                    chunks, mapper, config.num_map_workers,
                    config.max_retries,
                    pipeline_depth=obs.knob("pipeline_depth",
                                            config.pipeline_depth),
                    obs=obs):
                gidx = resume_k + idx
                _ingest(out, offsets.get(gidx))
                if ckpt is not None:
                    ckpt.save(gidx, out, offsets.get(gidx, -1))

    with obs.phase("finalize"):
        if engine is not None:
            hi, lo, vals, _n = engine.finalize()
            live = hi != np.uint32(SENTINEL)  # the engine pads with it
            regs = np.zeros(m, np.int32)
            regs[lo[live].astype(np.int64)] = vals[live]
        else:
            regs = host_regs
        estimate = hll_estimate(regs)

    with obs.phase("write"):
        if config.output_path:
            write_distinct_output(config.output_path, regs, estimate, p)

    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    metrics.set("records_in", records_in)
    metrics.set("chunks", n_chunks)
    metrics.set("registers_filled", int(np.count_nonzero(regs)))
    summary, trace = obs.finish(config, "distinct")
    result = DistinctResult(estimate=estimate, registers=regs,
                            metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result
