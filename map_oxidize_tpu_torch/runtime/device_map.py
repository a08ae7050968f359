"""Device-map job driver: word or n-gram count with the map on the device
(the port of the JAX package's ``runtime/device_map.py``: ``_prefix_packer``
:49, ``_DictBuilder`` :61, ``_SNAP_EVERY``, ``_open_snapshot`` :314,
``_resume_snapshot`` :336, ``run_device_wordcount_job`` :353; the sharded
``run_sharded_device_job`` waits for ROADMAP A7).

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
:class:`~map_oxidize_tpu_torch.runtime.pipeline.StagingRing`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.convert import (
    engine_state_from_jax,
    engine_state_to_numpy,
)
from map_oxidize_tpu_torch.io.splitter import iter_chunks_capped
from map_oxidize_tpu_torch.io.writer import write_final_result
from map_oxidize_tpu_torch.obs import Obs, observe_device_wait
from map_oxidize_tpu_torch.obs.compile import observed
from map_oxidize_tpu_torch.ops.device_tokenize import DeviceTokenizer, ngram_at
from map_oxidize_tpu_torch.ops.hashing import HashDictionary
from map_oxidize_tpu_torch.runtime.driver import (
    JobResult,
    _readback,
    _require_single_device,
)
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
    is one fetch per chunk."""

    def __init__(self, out_keys: int, fetch_keys: int, ngram: int = 1):
        self.dictionary = HashDictionary()
        self.out_keys = out_keys
        self.fetch_keys = min(fetch_keys, out_keys)
        self.records_in = 0
        self.ngram = ngram

    def process_packed(self, chunk: bytes, packed: np.ndarray,
                       fetch_overflow) -> None:
        """Update the dictionary from one fetched ``packed`` row (uint32);
        ``fetch_overflow(nu)`` returns the ``(hi, lo, rep)`` prefix when
        the chunk has more unique keys than ``packed`` carries."""
        nu, ndrop, ntok = packed[:3].astype(np.int64).tolist()
        if ndrop:
            raise CapacityError(
                f"{ndrop} unique keys dropped in a chunk: raise "
                "device_chunk_keys above the per-chunk distinct-key count"
            )
        self.records_in += ntok
        if nu == 0:
            return
        f = self.fetch_keys
        if nu <= f:
            hi, lo, rep = (packed[3:3 + nu],
                           packed[3 + f:3 + f + nu],
                           packed[3 + 2 * f:3 + 2 * f + nu])
        else:  # more novelty than the pre-packed window
            hi, lo, rep = fetch_overflow(nu)
        h64 = ((hi.astype(np.uint64) << np.uint64(32))
               | lo.astype(np.uint64)).tolist()
        d = self.dictionary
        rl = rep.astype(np.int64).tolist()
        ng = self.ngram
        for i, h in enumerate(h64):
            # unconditional add: on a repeat hash this compares the stored
            # bytes against this chunk's representative token, so a 64-bit
            # device-hash collision (two tokens, one hash) raises here just
            # as it would on the host paths instead of silently merging
            d.add(h, ngram_at(chunk, rl[i], ng))


class _PackedFetch:
    """Each chunk's ``packed`` row, copied to a pinned host buffer on the
    current stream right after the chunk's work, with an event; two
    buffers alternate, so chunk N's copy stays intact while chunk N+1's is
    in flight.  On the CPU the row is already on the host."""

    def __init__(self, device: torch.device, width: int):
        self.cuda = device.type == "cuda"
        self._bufs = [torch.empty(width, dtype=torch.int32,
                                  pin_memory=self.cuda) for _ in range(2)]
        self._events = ([torch.cuda.Event() for _ in range(2)]
                        if self.cuda else [None, None])
        self._side = torch.cuda.Stream(device) if self.cuda else None
        self._i = 0

    def start(self, outs):
        """Enqueue the copy of ``outs``' packed row; returns the pending
        handle for :meth:`finish`."""
        i, self._i = self._i, self._i ^ 1
        if not self.cuda:
            return outs, outs[4], None
        self._bufs[i].copy_(outs[4], non_blocking=True)
        self._events[i].record()
        return outs, self._bufs[i], self._events[i]

    def finish(self, pending):
        """Block until the pending copy has landed (timed into
        ``device/compute_ms``); returns ``(packed_u32, fetch_overflow)``."""
        outs, buf, event = pending
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        observe_device_wait(t0)
        u_hi, u_lo, _counts, reps, _packed = outs
        out_keys = u_hi.shape[0]

        def fetch_overflow(nu: int):
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

        return buf.numpy().view(np.uint32), fetch_overflow


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


def _resume_snapshot(ckpt, engine, set_dictionary) -> tuple[int, int]:
    """Shared snapshot restore: import the engine state, hand the
    dictionary and the prior records_in to ``set_dictionary``, return
    ``(resume_offset, n_chunks)`` ((0, 0) when there is nothing to
    resume)."""
    if ckpt is None:
        return 0, 0
    snap = ckpt.load_snapshot()
    if snap is None:
        return 0, 0
    state, d, resume_off, n_chunks, extra = snap
    engine.import_state(engine_state_from_jax(state, engine.device))
    set_dictionary(d, int(extra["records_in"]))
    _log.info("resumed device-map snapshot: %d chunks, offset %d",
              n_chunks, resume_off)
    return resume_off, n_chunks


def run_device_wordcount_job(config: JobConfig, ngram: int = 1,
                             on_obs=None) -> JobResult:
    """Word (``ngram=1``) or n-gram count with the map phase on the device,
    on one device; ``num_shards > 1`` raises, naming ROADMAP A7."""
    config.validate()
    _require_single_device(config)
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
    dicts = _DictBuilder(tok.out_keys, tok.fetch_keys, ngram)

    ckpt = _open_snapshot(config, f"device-map-ngram{ngram}", 1,
                          registry=metrics)

    def _set_dict(d, records):
        dicts.dictionary = d
        dicts.records_in = records
        engine.hint_live_upper_bound(len(d))

    resume_off, n_chunks = _resume_snapshot(ckpt, engine, _set_dict)

    ring = StagingRing(2, tok.n, 1, torch.uint8, engine.device)
    fetch = _PackedFetch(engine.device, 3 + 3 * tok.fetch_keys)

    def _process(pending) -> None:
        chunk, handle = pending
        dicts.process_packed(chunk, *fetch.finish(handle))

    pending: tuple | None = None
    off = resume_off
    hb_records = dicts.records_in
    with obs.phase("map+reduce"):
        for seq, chunk in enumerate(iter_chunks_capped(
                config.input_path, config.chunk_bytes, resume_off)):
            slot = ring.stage(seq, tok.pad_chunk(chunk)[:, None])
            outs = tok.map_padded(ring.acquire(slot).view(-1))
            ring.release(slot, seq)
            engine.feed_device(outs[0], outs[1], outs[2])  # async merge
            handle = fetch.start(outs)
            if pending is not None:
                _process(pending)  # blocks; overlaps this chunk's work
            pending = (chunk, handle)
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
        counts = _readback(engine, dicts.dictionary)
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
