"""Multi-process dataflow drivers: sort / join / sessionize over the
lockstep machinery of :mod:`.distributed`.  The port of the JAX package's
``parallel/dataflow.py`` (whole).

Every process maps its deterministic chunk subset (``index % P``), record
blocks cross the process boundary through the SAME lockstep exchange the
inverted index uses (:class:`~map_oxidize_tpu_torch.parallel.distributed.
DistributedCollectEngine`: range-partitioned for the sort,
hash-partitioned for join and sessionize), and each process finalizes and
writes ONLY the partition its mesh slice owns (``<output>.part<p>of<P>``).
Under the range partition a process's shards are a CONTIGUOUS key range,
so the sort parts, concatenated process-major, are the globally sorted
artifact; a sort past the device spills each process's disjoint partition
to private disk buckets and the bucket drain keeps the total order.
Global facts (row, match and session totals) reduce over tiny fixed-width
allgathers.
"""

from __future__ import annotations

import numpy as np

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.runtime.dataflow import (
    JoinResult,
    SessionizeResult,
    SortResult,
    device_wait_window,
    host_sort_window,
)


def run_distributed_dataflow(config: JobConfig, workload: str, obs: Obs):
    """Dispatch one distributed dataflow workload (called inside the
    flight recorder by :func:`parallel.distributed.run_distributed_job`)."""
    if workload == "sort":
        return _run_distributed_sort(config, obs)
    if workload == "join":
        return _run_distributed_join(config, obs)
    if workload == "sessionize":
        return _run_distributed_sessionize(config, obs)
    raise ValueError(f"unknown dataflow workload {workload!r}")


def _make_engine(config: JobConfig, splitters=None):
    from map_oxidize_tpu_torch.parallel.distributed import (
        DistributedCollectEngine,
    )
    from map_oxidize_tpu_torch.runtime.driver import collect_engine_kw

    return DistributedCollectEngine(config, splitters=splitters,
                                    pair_order="lex",
                                    **collect_engine_kw(config))


def _record_source(config: JobConfig, obs: Obs, proc: int, n_proc: int,
                   corpora, base_off: int = 0):
    """Yield this process's owned ``(keys u64, docs i64)`` record blocks
    across ``corpora`` (``(path, doc_fn)`` pairs).  ``base_off`` offsets
    the heartbeat's byte progress for a SECOND feed loop (the join's
    probe corpus): per-file offsets restart at 0 and the heartbeat's
    monotone-max would otherwise discard that corpus's progress."""
    from map_oxidize_tpu_torch.workloads.sort import iter_record_chunks

    rows_per_chunk = max(1, config.chunk_bytes // 16)
    base = base_off
    for path, doc_fn in corpora:
        end = 0
        for k, p, end in iter_record_chunks(path, rows_per_chunk, proc,
                                            n_proc):
            with obs.tracer.span("dist/map_chunk",
                                 bytes=16 * int(k.shape[0])):
                d = doc_fn(p, path)
            if obs.heartbeat is not None:
                obs.heartbeat.update(rows=int(k.shape[0]),
                                     bytes_done=base + end * 16)
            yield k, d
        base += end * 16


def _lockstep_feed(obs: Obs, engine, source, round_base: int = 0):
    """Drive one lockstep feed loop to exhaustion ACROSS processes:
    stage this process's blocks, psum the continue flag each round with
    the actual staged row count riding it (the synchronized global count
    the disk demotion trips on), pop ``local_rows`` per round into
    ``merge_local``.  Returns ``(records, flag_rounds)`` — the flag
    WAIT itself is recorded by ``any_remaining`` into the
    ``dist/flag_wait_ms`` histogram the attribution ledger reads.

    ``round_base`` offsets the ``round=`` sequence tags on the flag and
    exchange spans (the happens-before barrier tags
    :mod:`~map_oxidize_tpu_torch.obs.critpath` joins on): the join's SECOND
    feed loop passes the first loop's round count so the tags stay
    globally unique and lockstep-aligned across both corpora."""
    from map_oxidize_tpu_torch.ops.hashing import split_u64

    staged: list = []
    staged_rows = 0
    records = 0
    exhausted = False
    flag_rounds = 0
    while True:
        while not exhausted and staged_rows < engine.local_rows:
            try:
                k, d = next(source)
            except StopIteration:
                exhausted = True
                break
            staged.append((k, d))
            staged_rows += int(k.shape[0])
            records += int(k.shape[0])
        have = staged_rows > 0
        with obs.tracer.span("dist/lockstep_flag",
                             round=round_base + flag_rounds):
            cont = engine.any_remaining(
                have, rows=min(staged_rows, engine.local_rows))
        flag_rounds += 1
        if not cont:
            break
        if staged:
            keys = np.concatenate([b[0] for b in staged])
            docs = np.concatenate([b[1] for b in staged])
        else:
            keys = np.empty(0, np.uint64)
            docs = np.empty(0, np.int64)
        take = min(engine.local_rows, int(keys.shape[0]))
        staged = [(keys[take:], docs[take:])]
        staged_rows = int(keys.shape[0]) - take
        hi, lo = split_u64(keys[:take])
        du = docs[:take].view(np.uint64)
        vals = np.empty((take, 2), np.uint32)
        vals[:, 0] = (du >> np.uint64(32)).astype(np.uint32)
        vals[:, 1] = (du & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        # the round's wall beyond what the observatory itself records
        # (compile, dispatch gaps, sampled waits, spill I/O) is the
        # blocking fetch of the routed block + global-array assembly —
        # consumer-visible device time the attribution ledger must see
        with obs.tracer.span("dist/merge_local", rows=take,
                             round=round_base + flag_rounds - 1):
            with device_wait_window(obs):
                engine.merge_local(hi, lo, vals)
    return records, flag_rounds


def _gather_totals(vals, obs, program: str):
    """Sum per-process i64 facts: allgather one fixed-width vector,
    reduce on the host (identical everywhere)."""
    from map_oxidize_tpu_torch.parallel.distributed import _allgather_i64

    g = _allgather_i64(np.asarray(vals, np.int64), obs, program=program)
    return g.sum(axis=0)


def _finish(result, obs: Obs, config: JobConfig, workload: str):
    from map_oxidize_tpu_torch.parallel.distributed import finish_distributed_obs

    result.metrics, result.trace = finish_distributed_obs(obs, config,
                                                          workload)
    return result


def _part_path(config: JobConfig, engine) -> str:
    from map_oxidize_tpu_torch.parallel.distributed import partition_output_path

    return partition_output_path(config.output_path, engine.proc,
                                 engine.n_proc)


# --- sort ------------------------------------------------------------------


def _run_distributed_sort(config: JobConfig, obs: Obs) -> SortResult:
    from map_oxidize_tpu_torch.runtime.driver import effective_num_shards
    from map_oxidize_tpu_torch.workloads.sort import (
        compute_splitters,
        range_partition,
        sample_keys,
        write_sorted_records,
    )

    registry = obs.registry
    S = effective_num_shards(config)
    with obs.phase("sample"):
        # the strided sample reads the SHARED input identically on every
        # process, so the splitters agree with no collective
        splitters = compute_splitters(
            sample_keys(config.input_path, config.sort_sample), S)
    engine = _make_engine(config, splitters=splitters)
    engine.obs = obs
    registry.set("shuffle/transport", engine.transport)
    registry.set("sort/splitters", int(splitters.shape[0]))
    proc, P_ = engine.proc, engine.n_proc
    spp = engine.S // P_   # shards (= contiguous key ranges) per process

    with obs.phase("map+route"):
        records, flag_rounds = _lockstep_feed(
            obs, engine, _record_source(
                config, obs, proc, P_,
                [(config.input_path, lambda p, _path: p.view(np.int64))]))

    rows_local = 0
    with obs.phase("merge"):
        if engine.spilled:
            # this process's buckets hold exactly the rows its shard
            # range owns; the ordered drain writes the part with one
            # bucket resident at a time
            runs = engine.finalize_spilled_runs()
            with host_sort_window(obs):
                if config.output_path:
                    rows_local = write_sorted_records(
                        _part_path(config, engine), runs)
                else:
                    rows_local = sum(int(k.shape[0]) for k, _d in runs)
        else:
            with device_wait_window(obs):
                keys, docs = engine.finalize()  # replicated, global order
            with host_sort_window(obs):
                dest = range_partition(keys, splitters)
                own = (dest >= proc * spp) & (dest < (proc + 1) * spp)
                rows_local = int(own.sum())
                if config.output_path:
                    write_sorted_records(_part_path(config, engine),
                                         [(keys[own], docs[own])])
    totals = _gather_totals([rows_local, records,
                             int(engine.spilled_rows)], obs,
                            "dist/sort_totals")
    n_rows, n_records, spilled = (int(x) for x in totals)
    if n_rows != n_records:
        raise RuntimeError(
            f"distributed sort row conservation violated: {n_records} "
            f"rows fed globally, {n_rows} written")
    registry.set("records_in", records)
    registry.set("rows_out", rows_local)
    registry.set("flag_rounds", flag_rounds)
    result = SortResult(n_rows=n_rows, n_shards=engine.S,
                        splitters=splitters, spilled_rows=spilled)
    return _finish(result, obs, config, "sort")


# --- join ------------------------------------------------------------------


def _owned_csr(engine, keys: np.ndarray, docs: np.ndarray):
    """This process's hash partition of a replicated sorted row stream,
    as a grouped CSR: owner shard recomputed on the host with the SAME
    plane mix the in-trace router uses (:func:`~map_oxidize_tpu_torch.parallel.shuffle.bucket_of`)."""
    from map_oxidize_tpu_torch.ops.hashing import split_u64
    from map_oxidize_tpu_torch.workloads.join import csr_from_sorted

    hi, lo = split_u64(keys)
    owner = ((hi ^ lo) % np.uint32(engine.S)).astype(np.int64)
    spp = engine.S // engine.n_proc
    own = (owner >= engine.proc * spp) & (owner < (engine.proc + 1) * spp)
    return csr_from_sorted(keys[own], docs[own])


def _grouped_partition(config: JobConfig, obs: Obs, engine):
    """Grouped-CSR finalize of THIS process's partition: the spilled
    engine's buckets ARE the partition; the resident path replicates and
    selects the owned hash range."""
    if engine.spilled:
        with host_sort_window(obs):
            terms, offsets, docs, holder = engine.finalize_spilled_csr()
        return terms, offsets, docs, holder
    with device_wait_window(obs):
        keys, docs = engine.finalize()
    with host_sort_window(obs):
        csr = _owned_csr(engine, keys, docs)
    return (*csr, None)


def _run_distributed_join(config: JobConfig, obs: Obs) -> JoinResult:
    from map_oxidize_tpu_torch.workloads.join import (
        check_join_payloads,
        lexsort_matches,
        probe_join_csr,
        tag_side,
        write_join_records,
    )

    if not config.join_input_path:
        raise ValueError(
            "join needs the right-side corpus: --join-input "
            "(config.join_input_path)")
    registry = obs.registry
    engine = _make_engine(config)
    engine.obs = obs
    registry.set("shuffle/transport", engine.transport)
    proc, P_ = engine.proc, engine.n_proc

    sides = {}

    def _doc_fn(right):
        def fn(p, path):
            check_join_payloads(p, path)
            sides[right] = sides.get(right, 0) + int(p.shape[0])
            return tag_side(p, right).view(np.int64)
        return fn

    # two lockstep loops, one per corpus: every process drains corpus A
    # before any feeds B, so the feed order (and the engine's cumulative
    # synchronized row count) is identical everywhere
    from map_oxidize_tpu_torch.workloads.sort import load_records

    _k, _p, left_rows = load_records(config.input_path)
    with obs.phase("map+route"):
        rec_a, fr_a = _lockstep_feed(
            obs, engine, _record_source(config, obs, proc, P_,
                                        [(config.input_path,
                                          _doc_fn(False))]))
        rec_b, fr_b = _lockstep_feed(
            obs, engine, _record_source(config, obs, proc, P_,
                                        [(config.join_input_path,
                                          _doc_fn(True))],
                                        base_off=left_rows * 16),
            round_base=fr_a)
    records = rec_a + rec_b

    with obs.phase("merge"):
        terms, offsets, docs, holder = _grouped_partition(config, obs,
                                                          engine)
        with host_sort_window(obs):
            mk, ma, mb = probe_join_csr(terms, offsets, docs)
            mk, ma, mb = lexsort_matches(mk, ma, mb)
        del holder

    if config.output_path:
        with obs.phase("write"):
            write_join_records(_part_path(config, engine), mk, ma, mb)
    totals = _gather_totals(
        [int(mk.shape[0]), sides.get(False, 0), sides.get(True, 0),
         int(terms.shape[0])], obs, "dist/join_totals")
    n_matches, n_left, n_right, n_keys = (int(x) for x in totals)
    registry.set("records_in", records)
    registry.set("join/matches", int(mk.shape[0]))
    registry.set("flag_rounds", fr_a + fr_b)
    result = JoinResult(n_matches=n_matches, n_left=n_left,
                        n_right=n_right, n_keys=n_keys)
    return _finish(result, obs, config, "join")


# --- sessionize ------------------------------------------------------------


def _run_distributed_sessionize(config: JobConfig, obs: Obs
                                ) -> SessionizeResult:
    from map_oxidize_tpu_torch.workloads.sessionize import (
        sessions_from_csr,
        sort_sessions,
        write_sessions,
    )

    registry = obs.registry
    engine = _make_engine(config)
    engine.obs = obs
    registry.set("shuffle/transport", engine.transport)
    proc, P_ = engine.proc, engine.n_proc

    with obs.phase("map+route"):
        records, flag_rounds = _lockstep_feed(
            obs, engine, _record_source(
                config, obs, proc, P_,
                [(config.input_path, lambda p, _path: p.view(np.int64))]))

    with obs.phase("merge"):
        terms, offsets, docs, holder = _grouped_partition(config, obs,
                                                          engine)
        with host_sort_window(obs):
            sk, ss, se, sc = sessions_from_csr(terms, offsets, docs,
                                               config.session_gap)
            sk, ss, se, sc = sort_sessions(sk, ss, se, sc)
        del holder

    if config.output_path:
        with obs.phase("write"):
            write_sessions(_part_path(config, engine), sk, ss, se, sc)
    totals = _gather_totals(
        [int(sk.shape[0]), int(sc.sum()), int(terms.shape[0]), records],
        obs, "dist/sessionize_totals")
    n_sessions, covered, n_keys, n_events = (int(x) for x in totals)
    if covered != n_events:
        raise RuntimeError(
            f"distributed sessionize event conservation violated: "
            f"{n_events} events fed globally, sessions cover {covered}")
    registry.set("records_in", records)
    registry.set("sessions/count", int(sk.shape[0]))
    registry.set("flag_rounds", flag_rounds)
    result = SessionizeResult(n_sessions=n_sessions, n_events=n_events,
                              n_keys=n_keys)
    return _finish(result, obs, config, "sessionize")
