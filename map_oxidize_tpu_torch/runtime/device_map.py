"""Device-map job driver: word or n-gram count with the map on the device
(the port of the JAX package's ``runtime/device_map.py``: ``_prefix_packer``
:49, ``_DictBuilder`` :61, ``_SNAP_EVERY``, ``_open_snapshot`` :314,
``_resume_snapshot`` :336, ``run_device_wordcount_job`` :353, and the
sharded ``run_sharded_device_job`` :122 with ``_dispatch_group`` :294).

The host streams file bytes to the device and keeps the hash -> token-bytes
dictionary, sliced from the raw chunk at device-reported representative
offsets.  Tokenize, hash, combine
(:mod:`map_oxidize_tpu_torch.ops.device_tokenize`, the
``tokenize_compact`` kernel on the card) and the streaming fold
(:meth:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine.
feed_device`) run on the device.

Pipelining, as in the JAX package: chunk N+1's upload, tokenize and merge
are enqueued before the host blocks on chunk N's dictionary rows.  A CUDA
stream runs in order, so a plain fetch of chunk N issued after chunk N+1's
work would wait for that work too: chunk N's ``packed`` row is copied into
a pinned host buffer (``non_blocking``, with an event) right after chunk
N's own work, and the host waits on that event.  The rare overflow fetch
(more unique keys than ``packed`` carries) runs on a side stream that waits
on the same event.  Chunks stage through a pinned
:class:`~map_oxidize_tpu_torch.runtime.pipeline.StagingRing`: each is read
from the file straight into its slot
(:func:`~map_oxidize_tpu_torch.io.splitter.iter_chunks_into`), padded
there with spaces, and the dictionary is built from the slot, which the
next chunk but one refills.

Sharded (``num_shards > 1``): chunks are dealt onto the shards in groups
of S; one staged copy carries the group, ``device_map/tokenize_group``
runs the tokenizer once per shard on its chunk (one ``tokenize_compact``
launch each on the card), and the per-shard unique rows flow straight
into the sharded engine's exchange (``ShardedReduceEngine.feed_device``).
The host streams file bytes and fetches each group's packed dictionary
rows once, one group behind.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.convert import (
    engine_state_from_jax,
    engine_state_to_numpy,
)
from map_oxidize_tpu_torch.io.splitter import (
    iter_chunks_capped,
    iter_chunks_into,
)
from map_oxidize_tpu_torch.io.writer import write_final_result
from map_oxidize_tpu_torch.obs import Obs, observe_device_wait
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.device_tokenize import (
    DeviceTokenizer,
    pad_chunk,
    tokenize_count_core,
)
from map_oxidize_tpu_torch.runtime.device_dict import NativeDictionary
from map_oxidize_tpu_torch.runtime.driver import JobResult, _readback
from map_oxidize_tpu_torch.runtime.engine import (
    CapacityError,
    DeviceReduceEngine,
    next_pow2,
)
from map_oxidize_tpu_torch.runtime.pipeline import StagingRing
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: snapshot cadence for the device-map checkpoint (chunks between engine
#: state spills); each snapshot serializes the pipeline for one dictionary
#: fetch, so the cadence trades resume granularity against overlap
_SNAP_EVERY = 16


@observed("device_map/prefix_pack")
def _prefix_packer(u_hi, u_lo, reps, m: int) -> torch.Tensor:
    """``[3, m]`` (hi, lo, rep) prefix, fetched only when a chunk's novelty
    exceeds the pre-packed ``fetch_keys`` rows."""
    return torch.stack([u_hi[:m], u_lo[:m], reps[:m]])


class _DictBuilder:
    """Builds the hash -> token-bytes dictionary from the device outputs
    (JAX ``_DictBuilder``).  The kernel pre-packs the scalars and the first
    ``fetch_keys`` dictionary rows into one array, so the steady-state cost
    is one fetch per chunk; the dictionary is a
    :class:`~map_oxidize_tpu_torch.runtime.device_dict.NativeDictionary`,
    one native call per chunk (``obs`` times its materialization)."""

    def __init__(self, out_keys: int, fetch_keys: int, ngram: int = 1,
                 obs=None):
        self.dictionary = NativeDictionary(obs)
        self.out_keys = out_keys
        self.fetch_keys = min(fetch_keys, out_keys)
        self.records_in = 0
        self.ngram = ngram

    def process_packed(self, chunk, packed: np.ndarray,
                       fetch_overflow) -> tuple[int, int]:
        """Update the dictionary from one fetched ``packed`` row (uint32);
        ``chunk`` is the chunk's bytes or a view of them, of which only
        each added key's bytes are copied out; ``fetch_overflow(nu)``
        returns the ``(hi, lo, rep)`` prefix when the chunk has more
        unique keys than ``packed`` carries.  Returns the chunk's unique
        keys and how many of them were new to the dictionary."""
        nu, ndrop, ntok = packed[:3].astype(np.int64).tolist()
        if ndrop:
            raise CapacityError(
                f"{ndrop} unique keys dropped in a chunk: raise "
                "device_chunk_keys above the per-chunk distinct-key count"
            )
        self.records_in += ntok
        if nu == 0:
            return 0, 0
        f = self.fetch_keys
        if nu <= f:
            hi, lo, rep = (packed[3:3 + nu],
                           packed[3 + f:3 + f + nu],
                           packed[3 + 2 * f:3 + 2 * f + nu])
        else:  # more novelty than the pre-packed window
            hi, lo, rep = fetch_overflow(nu)
        # every key is checked: on a repeat hash the stored bytes are
        # compared with this chunk's representative token, so a 64-bit
        # device-hash collision (two tokens, one hash) raises here just as
        # it would on the host paths instead of silently merging
        return nu, self.dictionary.add_chunk(chunk, hi, lo, rep, self.ngram)


class _PackedFetch:
    """Each chunk's ``packed`` row, copied to a pinned host buffer on the
    current stream right after the chunk's work, with an event; two
    buffers alternate, so chunk N's copy stays intact while chunk N+1's is
    in flight.  On the CPU the row is already on the host.  A sharded
    group's rows are one ``[S * width]`` row of the shards' rows."""

    def __init__(self, device: torch.device, width: int):
        self.cuda = device.type == "cuda"
        self._bufs = [torch.empty(width, dtype=torch.int32,
                                  pin_memory=self.cuda) for _ in range(2)]
        self._events = ([torch.cuda.Event() for _ in range(2)]
                        if self.cuda else [None, None])
        self._side = torch.cuda.Stream(device) if self.cuda else None
        self._i = 0

    def start(self, outs: list, packed):
        """Enqueue the copy of ``packed``, the packed rows of the shards'
        tokenizer outputs ``outs`` (one per shard; one on one device);
        returns the pending handle for :meth:`finish`."""
        i, self._i = self._i, self._i ^ 1
        if not self.cuda:
            return outs, packed, None
        self._bufs[i].copy_(packed, non_blocking=True)
        self._events[i].record()
        return outs, self._bufs[i], self._events[i]

    def finish(self, pending):
        """Block until the pending copy has landed (timed into
        ``device/compute_ms``); returns ``(packed_u32, fetch_overflow,
        wait_ms)``, ``fetch_overflow(nu, s)`` of shard ``s`` (default 0)
        and ``wait_ms`` the wait."""
        outs, buf, event = pending
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        wait_ms = observe_device_wait(t0)
        packed = buf.numpy().view(np.uint32)
        return packed, (lambda nu, s=0: self._overflow(outs[s], event,
                                                       nu)), wait_ms

    def _overflow(self, outs, event, nu: int):
        """The ``(hi, lo, rep)`` prefix of a chunk with more unique keys
        than its packed row carries."""
        u_hi, u_lo, _counts, reps, _packed = outs
        out_keys = u_hi.shape[0]
        m = min(next_pow2(nu), out_keys)
        if event is None:
            over = _prefix_packer(u_hi, u_lo, reps, m)
        else:
            # on a side stream ordered after this chunk's work only,
            # not after the next chunk's, which is already enqueued
            with torch.cuda.stream(self._side):
                self._side.wait_event(event)
                over = _prefix_packer(u_hi, u_lo, reps, m).cpu()
        over = over.numpy().view(np.uint32)
        return over[0][:nu], over[1][:nu], over[2][:nu]


def _open_snapshot(config: JobConfig, workload_tag: str, num_shards: int,
                   registry=None):
    """Device-map checkpointing: map outputs never exist on the host here,
    so the resumable artifact is a periodic SNAPSHOT of the reduced state
    (engine accumulator + dictionary + input byte offset), in the JAX
    package's format, so a snapshot resumes in either package.  The shard
    count is part of the identity."""
    if not config.checkpoint_dir:
        return None
    from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore

    return CheckpointStore(
        config.checkpoint_dir,
        CheckpointStore.job_meta(
            config, workload_tag,
            extra={"num_shards": num_shards,
                   "device_chunk_keys": config.device_chunk_keys}),
        registry=registry)


def _resume_snapshot(ckpt, import_state,
                     set_dictionary) -> tuple[int, int]:
    """Shared snapshot restore: hand the engine state (the JAX layout) to
    ``import_state``, the dictionary and the prior records_in to
    ``set_dictionary``, return ``(resume_offset, n_chunks)`` ((0, 0) when
    there is nothing to resume)."""
    if ckpt is None:
        return 0, 0
    snap = ckpt.load_snapshot()
    if snap is None:
        return 0, 0
    state, d, resume_off, n_chunks, extra = snap
    import_state(state)
    set_dictionary(d, int(extra["records_in"]))
    _log.info("resumed device-map snapshot: %d chunks, offset %d",
              n_chunks, resume_off)
    return resume_off, n_chunks


def run_device_wordcount_job(config: JobConfig, ngram: int = 1,
                             on_obs=None) -> JobResult:
    """Word (``ngram=1``) or n-gram count with the map phase on the device,
    on one device."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "bigram" if ngram == 2 else "wordcount"):
        return _run_device_wordcount_body(config, obs, ngram)


def _run_device_wordcount_body(config: JobConfig, obs,
                               ngram: int) -> JobResult:
    metrics = obs.registry
    engine = DeviceReduceEngine(config, SumReducer())
    engine.obs = obs
    tok = DeviceTokenizer(config.chunk_bytes, config.device_chunk_keys,
                          device=engine.device, ngram=ngram)
    dicts = _DictBuilder(tok.out_keys, tok.fetch_keys, ngram, obs)

    ckpt = _open_snapshot(config, f"device-map-ngram{ngram}", 1,
                          registry=metrics)

    def _set_dict(d, records):
        dicts.dictionary.update(d)  # each restored key checked in
        dicts.records_in = records
        engine.hint_live_upper_bound(len(d))

    resume_off, n_chunks = _resume_snapshot(
        ckpt, lambda st: engine.import_state(
            engine_state_from_jax(st, engine.device)), _set_dict)

    ring = StagingRing(2, tok.n, 1, torch.uint8, engine.device)
    fetch = _PackedFetch(engine.device, 3 + 3 * tok.fetch_keys)

    def _process(pending) -> None:
        seq, chunk, handle = pending
        with obs.tracer.span("device_map/fetch_wait", seq=seq,
                             bytes=len(chunk)):
            packed, overflow, wait_ms = fetch.finish(handle)
        # the wait's own two clock reads, already device/compute_ms's
        metrics.count("device_map/fetch_wait_ms", wait_ms)

        def _overflow(nu):
            metrics.count("device_map/overflow_fetches")
            with obs.step("device_map/overflow", seq=seq, keys=nu):
                return overflow(nu)

        with obs.step("device_map/dict", seq=seq, bytes=len(chunk)) as span:
            nu, new = dicts.process_packed(chunk, packed, _overflow)
            span.set(keys=nu, new_keys=new)
        metrics.count("device_map/chunk_keys", nu)

    # each chunk's host steps, spans when traced and device_map/<step>_ms
    # counters always: read (the slot's release wait, the carry, the
    # readinto and the cut at whitespace), stage (the space fill and the
    # copy's start), enqueue (the tokenizer, the fold and the packed
    # copy), then fetch_wait and dict one chunk behind; inside dict, the
    # overflow fetch of a chunk with more unique keys than its packed row
    # carries.  The dict step reads chunk seq in its slot, which chunk
    # seq + 2 refills: its read comes after chunk seq + 1's enqueue, and
    # so after seq's dict step.  The counter chunk_keys sums the chunks'
    # unique keys; the dict span carries its chunk's keys and new_keys.
    # The dictionary's one materialization, in the write phase, is the
    # span and counter device_map/materialize(_ms)
    chunks = iter_chunks_into(config.input_path, config.chunk_bytes,
                              lambda seq: ring.host_slot(seq).reshape(-1),
                              resume_off)
    for name in ("device_map/cut_fallbacks", "device_map/carry_bytes",
                 "device_map/overflow_fetches", "device_map/overflow_ms",
                 "device_map/chunk_keys", "device_map/materialize_ms"):
        metrics.count(name, 0)
    pending: tuple | None = None
    off = resume_off
    hb_records = dicts.records_in
    with obs.phase("map+reduce"):
        for seq in itertools.count():
            with obs.step("device_map/read", seq=seq) as span:
                filled = next(chunks, None)
                span.set(bytes=0 if filled is None else filled.length)
            if filled is None:
                break
            chunk = filled.data
            metrics.count("device_map/cut_fallbacks",
                          int(filled.cut_fallback))
            metrics.count("device_map/carry_bytes", filled.carry_in)
            with obs.step("device_map/stage", seq=seq, bytes=len(chunk)):
                filled.buf[filled.length:] = 32  # no stale byte past it
                slot = ring.start_copy(seq, tok.n)
            with obs.step("device_map/enqueue", seq=seq, bytes=len(chunk)):
                outs = tok.map_padded(ring.acquire(slot).view(-1))
                ring.release(slot, seq)
                engine.feed_device(outs[0], outs[1], outs[2])  # async
                handle = fetch.start([outs], outs[4])
            if pending is not None:
                _process(pending)  # blocks; overlaps this chunk's work
            pending = (seq, chunk, handle)
            n_chunks += 1
            off += len(chunk)
            if obs.heartbeat is not None:
                # rows = tokenized-record delta (one chunk behind — the
                # dictionary fetch is pipelined); bytes drive the percent
                obs.heartbeat.update(rows=dicts.records_in - hb_records,
                                     bytes_done=off)
                hb_records = dicts.records_in
            # the dictionary length is the exact global distinct-key count
            # (one chunk behind): feed it back so capacity growth rarely
            # needs its own device sync
            engine.hint_live_upper_bound(
                len(dicts.dictionary) + config.device_chunk_keys)
            if ckpt is not None and n_chunks % _SNAP_EVERY == 0:
                _process(pending)  # sync the dictionary to the engine
                pending = None
                ckpt.save_snapshot(
                    engine_state_to_numpy(engine.export_state()),
                    dicts.dictionary, off, n_chunks,
                    {"records_in": np.int64(dicts.records_in)})
        if pending is not None:
            _process(pending)
        if obs.heartbeat is not None:  # tail records the pipeline lagged
            obs.heartbeat.update(rows=dicts.records_in - hb_records)

    with obs.phase("finalize"):
        with obs.step("device_map/readback"):
            counts = _readback(engine, dicts.dictionary)
        with obs.step("device_map/top_k"):
            top = counts.top_k(config.top_k)

    total = counts.total()
    if dicts.records_in and total != dicts.records_in:
        raise RuntimeError(
            f"count conservation violated: device tokenized "
            f"{dicts.records_in} tokens but counts sum to {total}"
        )

    with obs.phase("write"):
        if config.output_path:
            write_final_result(config.output_path, counts.items())

    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    metrics.set("records_in", dicts.records_in)
    metrics.set("distinct_keys", len(counts))
    metrics.set("chunks", n_chunks)
    # the port's own: where the reduce ran (nothing falls back)
    metrics.set("accumulator_device", str(engine.device))
    summary, trace = obs.finish(config,
                                "bigram" if ngram == 2 else "wordcount")
    result = JobResult(counts=counts, top=top, metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


@observed("device_map/tokenize_group")
def _tokenize_group(chunks: list, *, max_tokens: int, out_keys: int,
                    fetch_keys: int, ngram: int) -> list:
    """One group (JAX ``device_map/tokenize_group``): the fused device map
    of each shard's chunk on its slot, ``(u_hi, u_lo, counts, reps,
    packed)`` per shard."""
    return [tokenize_count_core(c, max_tokens, out_keys, fetch_keys, ngram)
            for c in chunks]


def run_sharded_device_job(config: JobConfig, ngram: int = 1,
                           on_obs=None) -> JobResult:
    """Word or n-gram count with the map phase on the device across the
    mesh (JAX ``run_sharded_device_job``): chunks are dealt onto the
    shards in groups of S, the group is tokenized per shard, and the
    per-shard unique rows flow into the exchange with no host round trip;
    the host streams the file bytes and fetches each group's packed
    dictionary rows once, one group behind."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "bigram" if ngram == 2 else "wordcount"):
        return _run_sharded_device_body(config, obs, ngram)


def _run_sharded_device_body(config: JobConfig, obs,
                             ngram: int) -> JobResult:
    from dataclasses import replace

    from map_oxidize_tpu_torch.parallel.engine import ShardedReduceEngine
    from map_oxidize_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh

    metrics = obs.registry
    N = config.chunk_bytes
    max_tokens = N // 2 + 1
    out_keys = min(config.device_chunk_keys, max_tokens)  # kernel clamps
    fetch_keys = min(1 << 16, out_keys)
    # the mesh first: the engine's merge batch is one tokenized group (S
    # shards x out_keys rows), so its feed batch is sized for that, not
    # for config.batch_size.  The device hash's two lanes share their low
    # three bits, so (hi ^ lo) % S routes every key to shard 0 when S
    # divides 8 (ROADMAP C6).  The routing stays the JAX package's (its
    # snapshots cross) and the engine is sized for it: a bucket takes a
    # shard's whole chunk, a shard may hold every key, and one merge may
    # land a whole group on one shard, so capacity grows by a group and
    # each shard starts with the JAX engine's room plus one group
    mesh = make_mesh(config.num_shards, config.backend)
    S = mesh.shape[SHARD_AXIS]
    dev0 = mesh.devices[0]
    engine = ShardedReduceEngine(
        replace(config, batch_size=S * out_keys,
                key_capacity=S * config.key_capacity,
                initial_key_capacity=(config.initial_key_capacity
                                      + S * S * out_keys)),
        SumReducer(), mesh=mesh, bucket_cap=out_keys)
    engine.obs = obs
    dicts = [_DictBuilder(out_keys, fetch_keys, ngram) for _ in range(S)]

    ckpt = _open_snapshot(config, f"device-map-sharded-ngram{ngram}", S,
                          registry=metrics)

    def _set_dict(d, records):
        # the snapshot stores the UNION dictionary; shard 0 carries it on
        # resume (finalize unions the builders anyway)
        dicts[0].dictionary.update(d)
        dicts[0].records_in = records

    # the sharded engine reads the JAX layout itself
    resume_off, n_chunks = _resume_snapshot(ckpt, engine.import_state,
                                            _set_dict)

    ring = StagingRing(2, S * N, 1, torch.uint8, dev0)
    fetch = _PackedFetch(dev0, S * (3 + 3 * fetch_keys))
    seq = 0

    def _dispatch_group(group: list[bytes], pending):
        """Stage one S-chunk group, run the sharded tokenize, feed the
        engine (all enqueued), then block on the PREVIOUS group's
        dictionary fetch so it overlaps this group's work (JAX
        ``_dispatch_group``)."""
        nonlocal seq
        stacked = np.concatenate([pad_chunk(c, N) for c in group])
        slot = ring.stage(seq, stacked[:, None])
        outs = _tokenize_group(
            mesh.split(ring.acquire(slot).view(-1)), max_tokens=max_tokens,
            out_keys=out_keys, fetch_keys=fetch_keys, ngram=ngram)
        ring.release(slot, seq)
        seq += 1
        engine.feed_device([o[0] for o in outs], [o[1] for o in outs],
                           [o[2] for o in outs])
        handle = fetch.start(outs, torch.cat([o[4].to(dev0) for o in outs]))
        if pending is not None:
            _process_group(pending)
        return group, handle

    def _process_group(pending) -> None:
        group, handle = pending
        packed, overflow, _wait_ms = fetch.finish(handle)
        packed = packed.reshape(S, -1)  # ONE fetch per group
        for s, chunk in enumerate(group):
            dicts[s].process_packed(chunk, packed[s],
                                    lambda nu, s=s: overflow(nu, s))

    def _snapshot(off: int) -> None:
        union = NativeDictionary()
        for d in dicts:
            union.update(d.dictionary)
        ckpt.save_snapshot(
            engine.export_state(), union, off, n_chunks,
            {"records_in": np.int64(sum(d.records_in for d in dicts))})

    pending = None
    with obs.phase("map+reduce"):
        group: list[bytes] = []
        off = resume_off
        groups_done = 0
        hb_records = sum(d.records_in for d in dicts)
        for chunk in iter_chunks_capped(config.input_path, config.chunk_bytes,
                                        resume_off):
            group.append(bytes(chunk))
            n_chunks += 1
            off += len(chunk)
            if obs.heartbeat is not None:
                # rows = tokenized-record delta (one group behind: the
                # dictionary fetch is pipelined); bytes drive the percent
                total = sum(d.records_in for d in dicts)
                obs.heartbeat.update(rows=total - hb_records,
                                     bytes_done=off)
                hb_records = total
            if len(group) < S:
                continue
            pending = _dispatch_group(group, pending)
            group = []
            groups_done += 1
            engine.hint_live_upper_bound(
                sum(len(d.dictionary) for d in dicts) + 2 * S * out_keys)
            if ckpt is not None and groups_done % _SNAP_EVERY == 0:
                if pending is not None:
                    _process_group(pending)  # sync the dictionaries
                    pending = None
                _snapshot(off)
        if group:  # a short tail group: pad with empty (all-space) chunks
            group += [b""] * (S - len(group))
            pending = _dispatch_group(group, pending)
        if pending is not None:
            _process_group(pending)
        if obs.heartbeat is not None:  # tail records the pipeline lagged
            obs.heartbeat.update(
                rows=sum(d.records_in for d in dicts) - hb_records)

    with obs.phase("finalize"):
        dictionary = dicts[0].dictionary
        for d in dicts[1:]:
            dictionary.update(d.dictionary)
        counts = _readback(engine, dictionary)
        top = counts.top_k(config.top_k)

    records_in = sum(d.records_in for d in dicts)
    total = counts.total()
    if records_in and total != records_in:
        raise RuntimeError(
            f"count conservation violated: device tokenized "
            f"{records_in} records but counts sum to {total}")

    with obs.phase("write"):
        if config.output_path:
            write_final_result(config.output_path, counts.items())

    if ckpt is not None:
        ckpt.finish(config.keep_intermediates)

    metrics.set("records_in", records_in)
    metrics.set("distinct_keys", len(counts))
    metrics.set("chunks", n_chunks)
    metrics.set("shards", S)
    # the port's own: where the reduce ran (nothing falls back)
    metrics.set("accumulator_device", str(engine.device))
    summary, trace = obs.finish(config,
                                "bigram" if ngram == 2 else "wordcount")
    result = JobResult(counts=counts, top=top, metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result
