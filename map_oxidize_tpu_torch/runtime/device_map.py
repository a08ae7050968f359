"""Device-map job driver: word or n-gram count with the map on the device
(the port of the JAX package's ``runtime/device_map.py``: ``_prefix_packer``
:49, ``_DictBuilder`` :61, ``_SNAP_EVERY``, and one job for its
``run_device_wordcount_job`` :353 with ``_open_snapshot`` :314 and
``_resume_snapshot`` :336, and its sharded ``run_sharded_device_job`` :122
with ``_dispatch_group`` :294).

The host streams file bytes to the device and keeps the hash -> token-bytes
dictionary, sliced from the raw chunk at device-reported representative
offsets.  Tokenize, hash, combine
(:mod:`map_oxidize_tpu_torch.ops.device_tokenize`, the
``tokenize_compact`` kernel on the card) and the streaming fold
(:meth:`~map_oxidize_tpu_torch.runtime.engine.DeviceReduceEngine.
feed_device`) run on the device.

One job for one device and for a mesh of S shards: one loop over groups
of S chunks (S = 1 on one device).  Each chunk is read from the file
straight into its segment of the group's slot in a pinned
:class:`~map_oxidize_tpu_torch.runtime.pipeline.StagingRing`
(:func:`~map_oxidize_tpu_torch.io.splitter.iter_chunks_into`) and padded
there with spaces; one copy carries the group to the device.  Sharded,
``device_map/tokenize_group`` runs the tokenizer once per shard on its
chunk (one ``tokenize_compact`` launch each on the card) and the
per-shard unique rows flow straight into the sharded engine's exchange
(``ShardedReduceEngine.feed_device``).  One dictionary serves the job:
each chunk's keys are added from its own bytes in the slot, which the
group after next refills.

Pipelining, as in the JAX package: group N+1's upload, tokenize and merge
are enqueued before the host blocks on group N's dictionary rows.  A CUDA
stream runs in order, so a plain fetch of group N issued after group
N+1's work would wait for that work too: group N's ``packed`` rows are
copied into a pinned host buffer (``non_blocking``, with an event) right
after group N's own work, and the host waits on that event.  The rare
overflow fetch (more unique keys than ``packed`` carries) runs on a side
stream that waits on the same event.
"""

from __future__ import annotations

import itertools
import time
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.convert import (
    engine_state_from_jax,
    engine_state_to_numpy,
)
from map_oxidize_tpu_torch.io.splitter import iter_chunks_into
from map_oxidize_tpu_torch.io.writer import write_final_result
from map_oxidize_tpu_torch.obs import Obs, observe_device_wait
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.device_tokenize import (
    DeviceTokenizer,
    tokenize_count_core,
)
from map_oxidize_tpu_torch.runtime.checkpoint import CheckpointStore
from map_oxidize_tpu_torch.runtime.device_dict import NativeDictionary
from map_oxidize_tpu_torch.runtime.driver import (
    JobResult,
    _finish_wordcount,
    _readback,
    effective_num_shards,
)
from map_oxidize_tpu_torch.runtime.engine import (
    CapacityError,
    DeviceReduceEngine,
    next_pow2,
)
from map_oxidize_tpu_torch.runtime.pipeline import StagingRing
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: snapshot cadence for the device-map checkpoint (groups between engine
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
    one native call per chunk (``obs`` times its write and any
    materialization)."""

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


@observed("device_map/tokenize_group")
def _tokenize_group(chunks: list, *, max_tokens: int, out_keys: int,
                    fetch_keys: int, ngram: int) -> list:
    """One group (JAX ``device_map/tokenize_group``): the fused device map
    of each shard's chunk on its slot, ``(u_hi, u_lo, counts, reps,
    packed)`` per shard."""
    return [tokenize_count_core(c, max_tokens, out_keys, fetch_keys, ngram)
            for c in chunks]


class _Side(NamedTuple):
    """What a device-map job fixes at setup for its engine, on one device
    (S = 1) or across the mesh; the loop tests none of it."""

    engine: Any
    tok: DeviceTokenizer
    S: int
    #: the snapshot's workload tag
    tag: str
    #: the capacity hint's keys past the dictionary's, after each group
    slack: int
    #: the group's staged block -> each shard's tokenizer outputs
    map: Callable
    #: each shard's outputs -> the fold (enqueued)
    feed: Callable
    #: each shard's outputs -> the one row of ``packed`` rows to fetch
    packed: Callable
    #: the engine's state <-> the snapshot's (the JAX layout)
    export_state: Callable
    import_state: Callable


def _one_device(config: JobConfig, ngram: int) -> _Side:
    engine = DeviceReduceEngine(config, SumReducer())
    tok = DeviceTokenizer(config.chunk_bytes, config.device_chunk_keys,
                          device=engine.device, ngram=ngram)
    return _Side(
        engine, tok, 1, f"device-map-ngram{ngram}", config.device_chunk_keys,
        map=lambda block: [tok.map_padded(block)],
        feed=lambda outs: engine.feed_device(*outs[0][:3]),
        packed=lambda outs: outs[0][4],
        export_state=lambda: engine_state_to_numpy(engine.export_state()),
        import_state=lambda st: engine.import_state(
            engine_state_from_jax(st, engine.device)))


def _sharded(config: JobConfig, ngram: int) -> _Side:
    """JAX ``run_sharded_device_job``'s engine and group tokenizer."""
    from dataclasses import replace

    from map_oxidize_tpu_torch.parallel.engine import ShardedReduceEngine
    from map_oxidize_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh

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
    tok = DeviceTokenizer(config.chunk_bytes, config.device_chunk_keys,
                          device=mesh.devices[0], ngram=ngram)
    engine = ShardedReduceEngine(
        replace(config, batch_size=S * tok.out_keys,
                key_capacity=S * config.key_capacity,
                initial_key_capacity=(config.initial_key_capacity
                                      + S * S * tok.out_keys)),
        SumReducer(), mesh=mesh, bucket_cap=tok.out_keys)
    return _Side(
        engine, tok, S, f"device-map-sharded-ngram{ngram}",
        2 * S * tok.out_keys,
        map=lambda block: _tokenize_group(
            mesh.split(block), max_tokens=tok.max_tokens,
            out_keys=tok.out_keys, fetch_keys=tok.fetch_keys, ngram=ngram),
        feed=lambda outs: engine.feed_device(
            *([o[i] for o in outs] for i in range(3))),
        packed=lambda outs: torch.cat([o[4].to(engine.device)
                                       for o in outs]),
        export_state=engine.export_state, import_state=engine.import_state)


def run_device_wordcount_job(config: JobConfig, ngram: int = 1,
                             on_obs=None) -> JobResult:
    """Word (``ngram=1``) or n-gram count with the map phase on the device:
    on one device, or across the mesh when ``num_shards`` resolves past 1
    (chunks dealt onto the shards in groups of S, the group tokenized per
    shard, the per-shard unique rows into the exchange with no host round
    trip)."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "bigram" if ngram == 2 else "wordcount"):
        return _run_device_wordcount_body(config, obs, ngram)


def _run_device_wordcount_body(config: JobConfig, obs,
                               ngram: int) -> JobResult:
    metrics = obs.registry
    side = (_sharded if effective_num_shards(config) > 1
            else _one_device)(config, ngram)
    engine, tok, S = side.engine, side.tok, side.S
    engine.obs = obs
    N = tok.n
    dicts = _DictBuilder(tok.out_keys, tok.fetch_keys, ngram, obs)

    # map outputs never exist on the host here, so the resumable artifact
    # is a periodic snapshot of the reduced state (engine accumulator,
    # dictionary, input byte offset) in the JAX package's format, so a
    # snapshot resumes in either package; the shard count is part of its
    # identity
    ckpt = None
    resume_off = n_chunks = 0
    if config.checkpoint_dir:
        ckpt = CheckpointStore(config.checkpoint_dir, CheckpointStore.job_meta(
            config, side.tag, extra={
                "num_shards": S,
                "device_chunk_keys": config.device_chunk_keys}),
            registry=metrics)
        snap = ckpt.load_snapshot()
        if snap is not None:
            state, d, resume_off, n_chunks, extra = snap
            side.import_state(state)
            dicts.dictionary.update(d)  # each restored key checked in
            dicts.records_in = int(extra["records_in"])
            engine.hint_live_upper_bound(len(d))
            _log.info("resumed device-map snapshot: %d chunks, offset %d",
                      n_chunks, resume_off)

    ring = StagingRing(2, S * N, 1, torch.uint8, engine.device)
    fetch = _PackedFetch(engine.device, S * (3 + 3 * tok.fetch_keys))

    def _process(pending) -> None:
        seq, group, handle = pending
        with obs.tracer.span("device_map/fetch_wait", seq=seq,
                             bytes=sum(len(c) for c in group)):
            packed, overflow, wait_ms = fetch.finish(handle)
        # the wait's own two clock reads, already device/compute_ms's
        metrics.count("device_map/fetch_wait_ms", wait_ms)
        packed = packed.reshape(S, -1)  # one fetch a group
        for s, chunk in enumerate(group):
            def _overflow(nu, s=s):
                metrics.count("device_map/overflow_fetches")
                with obs.step("device_map/overflow", seq=seq + s, keys=nu):
                    return overflow(nu, s)

            with obs.step("device_map/dict", seq=seq + s,
                          bytes=len(chunk)) as span:
                nu, new = dicts.process_packed(chunk, packed[s], _overflow)
                span.set(keys=nu, new_keys=new)
            metrics.count("device_map/chunk_keys", nu)

    # each chunk's host steps, spans when traced and device_map/<step>_ms
    # counters always: read (the slot's release wait, the carry, the
    # readinto and the cut at whitespace), then per group of S chunks
    # (seq: its first chunk's) stage (the space fill and the copy's
    # start), enqueue (the tokenizer, the fold and the packed copy), and
    # fetch_wait one group behind; then each chunk's dict step; inside it,
    # the overflow fetch of a chunk with more unique keys than its packed
    # row carries.  Chunk seq fills segment seq % S of group seq // S's
    # slot, which group seq // S + 2 refills: its first read comes after
    # group seq // S + 1's enqueue, and so after seq's dict step.  The
    # counter chunk_keys sums the chunks' unique keys; the dict span
    # carries its chunk's keys and new_keys.  The write phase's native
    # call, which looks up, sorts, formats and writes the rows, is the
    # span and counter device_map/write(_ms), the rows it wrote the
    # counter device_map/write_rows; a consumer that iterates the counts
    # materializes the dictionary under device_map/materialize(_ms)
    chunks = iter_chunks_into(
        config.input_path, config.chunk_bytes,
        lambda seq: ring.host_slot(seq // S).reshape(-1)[
            seq % S * N:(seq % S + 1) * N],
        resume_off)
    for name in ("device_map/cut_fallbacks", "device_map/carry_bytes",
                 "device_map/overflow_fetches", "device_map/overflow_ms",
                 "device_map/chunk_keys", "device_map/materialize_ms",
                 "device_map/write_ms", "device_map/write_rows"):
        metrics.count(name, 0)
    pending: tuple | None = None
    off = resume_off
    hb_records = dicts.records_in
    with obs.phase("map+reduce"):
        for g in itertools.count():
            group = []
            for seq in range(g * S, (g + 1) * S):
                with obs.step("device_map/read", seq=seq) as span:
                    filled = next(chunks, None)
                    span.set(bytes=0 if filled is None else filled.length)
                if filled is None:
                    break
                metrics.count("device_map/cut_fallbacks",
                              int(filled.cut_fallback))
                metrics.count("device_map/carry_bytes", filled.carry_in)
                group.append(filled)
            if not group:
                break
            nbytes = sum(f.length for f in group)
            with obs.step("device_map/stage", seq=g * S, bytes=nbytes):
                for f in group:
                    f.buf[f.length:] = 32  # no stale byte past it
                if len(group) < S:  # a short last group's empty shards
                    ring.host_slot(g).reshape(-1)[len(group) * N:] = 32
                slot = ring.start_copy(g, S * N)
            with obs.step("device_map/enqueue", seq=g * S, bytes=nbytes):
                outs = side.map(ring.acquire(slot).view(-1))
                ring.release(slot, g)
                side.feed(outs)  # async
                handle = fetch.start(outs, side.packed(outs))
            if pending is not None:
                _process(pending)  # blocks; overlaps this group's work
            pending = (g * S, [f.data for f in group], handle)
            n_chunks += len(group)
            off += nbytes
            if obs.heartbeat is not None:
                # rows = tokenized-record delta (one group behind — the
                # dictionary fetch is pipelined); bytes drive the percent
                obs.heartbeat.update(rows=dicts.records_in - hb_records,
                                     bytes_done=off)
                hb_records = dicts.records_in
            if len(group) < S:
                break
            # the dictionary length is the exact global distinct-key count
            # (one group behind): feed it back so capacity growth rarely
            # needs its own device sync
            engine.hint_live_upper_bound(len(dicts.dictionary) + side.slack)
            if ckpt is not None and n_chunks % (S * _SNAP_EVERY) == 0:
                _process(pending)  # sync the dictionary to the engine
                pending = None
                ckpt.save_snapshot(
                    side.export_state(), dicts.dictionary, off, n_chunks,
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
    # the writer by this module's name, where portbench/faults.py's
    # altered_answer patches it
    return _finish_wordcount(
        config, obs, "bigram" if ngram == 2 else "wordcount", counts, top,
        ckpt, dicts.records_in, n_chunks, str(engine.device),
        write=write_final_result, **({"shards": S} if S > 1 else {}))
