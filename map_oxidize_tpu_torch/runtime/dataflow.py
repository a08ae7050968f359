"""Dataflow workload drivers on one device: total-order sort, hash
equi-join and sessionize (the port of the JAX package's
``runtime/dataflow.py``: ``device_wait_window`` :72, ``host_sort_window``
:102, ``_make_engine`` :122, ``_feed_records`` :145, ``_finalize_grouped``
:185, ``run_sort_job`` :236, ``run_join_job`` :342,
``run_sessionize_job`` :438).

All three ride the pair collect
(:class:`~map_oxidize_tpu_torch.runtime.collect.CollectEngine` with
``pair_order='lex'``), the one engine family whose rows SURVIVE the
reduce:

* **sort** feeds the (key, payload) records and writes the engine's
  full unsigned (key, payload) order; a beyond-RAM sort demotes to the
  disk buckets, whose top-bit ranges make the bucket drain itself the
  merge;
* **join** feeds TWO corpora into the engine with the side tagged in the
  payload's top bit; the (key, doc) sort leaves every key segment
  build-rows-then-probe-rows, and the probe is one vectorized CSR
  cross-product;
* **sessionize** feeds (key, timestamp) events; the same sort leaves each
  key's segment time-ascending, and one vectorized gap scan cuts
  sessions.

``collect_sort`` places the one sort: ``host`` (the ``auto`` default) is
numpy's lexsort; ``device`` packs the pairs into blocks on the card and
sorts them there (``runtime/collect.py`` ``sort_pairs``), with one fetch.
The sharded engines (``num_shards > 1``) raise, naming ROADMAP A7.

Attribution: the sample phase counts as host produce; the card sort's
finalize (launch, sort and its one fetch) lands in ``device_compute``;
all host-side finalize compute (lexsorts, the probe expansion, session
cuts, ordered drain writes) is measured into ``host_sort``, minus the
spill I/O paid inside the window, which ``spill_io`` owns.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs.attrib import _hist_total_ms
from map_oxidize_tpu_torch.runtime.pipeline import pipelined
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


@contextmanager
def device_wait_window(obs):
    """Measure one device-synchronous finalize (the card sort's launch,
    execution and fetch) into ``device/compute_ms``, MINUS what the port
    already recorded inside the window: the fetch that
    ``CollectEngine.finalize`` times into ``device/compute_ms`` itself, and
    spill I/O.  The JAX package also subtracts its compile-ledger walls and
    dispatch gaps; the port has neither, so only these two are
    subtracted.  The buckets stay disjoint."""
    if obs is None:
        yield
        return
    reg = obs.registry
    w0 = _hist_total_ms(reg, "device/compute_ms")
    io0 = float(reg.counters.get("spill/io_ms", 0.0))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt_ms = (time.perf_counter() - t0) * 1e3
        wait = max(dt_ms - (_hist_total_ms(reg, "device/compute_ms") - w0)
                   - (float(reg.counters.get("spill/io_ms", 0.0)) - io0),
                   0.0)
        reg.observe("device/compute_ms", wait)


@contextmanager
def host_sort_window(obs):
    """Measure one host-side dataflow-finalize window (sort / probe /
    session cuts / ordered drain writes) into the attribution ledger's
    ``host_sort`` bucket.  Spill I/O paid INSIDE the window is
    subtracted — the ``spill_io`` bucket owns it."""
    reg = obs.registry if obs is not None else None
    if reg is None:
        yield
        return
    io0 = float(reg.counters.get("spill/io_ms", 0.0))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt_ms = (time.perf_counter() - t0) * 1e3
        io_ms = float(reg.counters.get("spill/io_ms", 0.0)) - io0
        reg.count("attrib/host_sort_ms", max(dt_ms - io_ms, 0.0))


def _make_engine(config: JobConfig):
    """The dataflow engine: the pair collect with the full unsigned (key,
    doc) lexsort discipline (``pair_order='lex'`` — payload order is part
    of these workloads' oracle).  ``num_shards > 1`` raises."""
    from map_oxidize_tpu_torch.runtime.collect import CollectEngine
    from map_oxidize_tpu_torch.runtime.driver import (
        _require_single_device,
        collect_engine_kw,
    )
    from map_oxidize_tpu_torch.runtime.engine import pick_device

    _require_single_device(config)
    engine = CollectEngine(config, pair_order="lex",
                           **collect_engine_kw(config))
    if engine.device is None:
        # a host sort touches no device, but the job still runs on the
        # backend it asked for: a missing card raises here too
        pick_device(config.backend)
    return engine


def _finalize_sorted(obs: Obs, engine):
    """The resident engine's sorted ``(keys, docs)``: the card sort's
    finalize is device time, the host lexsort is host time."""
    window = (device_wait_window if engine.sort_mode == "device"
              else host_sort_window)
    with window(obs):
        return engine.finalize()


def _feed_records(config: JobConfig, obs: Obs, engine, corpora) -> tuple:
    """Stream record chunks from ``corpora`` (``(path, doc_fn)`` pairs;
    ``doc_fn(payloads, path) -> i64 doc column``) through the engine
    under the pipeline wrapper.  Returns ``(records, n_chunks)``."""
    from map_oxidize_tpu_torch.workloads.sort import iter_record_chunks

    metrics = obs.registry
    records = 0
    n_chunks = 0
    rows_per_chunk = max(1, config.chunk_bytes // 16)

    def _gen():
        # heartbeat offsets accumulate ACROSS corpora (the join feeds
        # two): per-file offsets restart at 0 and the heartbeat's
        # monotone max would discard the second corpus's progress
        base = 0
        for path, doc_fn in corpora:
            end = 0
            for k, p, end in iter_record_chunks(path, rows_per_chunk):
                out = MapOutput(hi=None, lo=None, values=None,
                                records_in=int(k.shape[0]), keys64=k,
                                docs64=doc_fn(p, path))
                yield out, base + end * 16
            base += end * 16

    for out, next_off in pipelined(_gen(), config.pipeline_depth, obs,
                                   name="map"):
        records += out.records_in
        n_chunks += 1
        t0 = time.perf_counter()
        with obs.feed_span(rows=len(out)):
            engine.feed(out)
        metrics.observe("feed_block_ms", (time.perf_counter() - t0) * 1e3)
        if obs.heartbeat is not None:
            obs.heartbeat.update(rows=out.records_in, bytes_done=next_off)
    return records, n_chunks


def _finalize_grouped(obs: Obs, engine):
    """Grouped-CSR finalize shared by join and sessionize: a spilled
    engine hands its CSR directly; a resident engine hands sorted rows,
    boundary-detected here.  Returns ``(terms, offsets, docs, holder)``
    (``holder`` keeps a spilled doc memmap alive)."""
    from map_oxidize_tpu_torch.workloads.join import csr_from_sorted

    if engine.spilled:
        with host_sort_window(obs):
            return engine.finalize_spilled_csr()
    keys, docs = _finalize_sorted(obs, engine)
    with host_sort_window(obs):
        csr = csr_from_sorted(keys, docs)
    return (*csr, None)


# --- total-order sort ------------------------------------------------------


@dataclass
class SortResult:
    """Global facts of a total-order sort; the sorted artifact itself
    streams to ``config.output_path`` (16-byte ``OUT_REC`` records)."""

    n_rows: int
    n_shards: int
    splitters: "np.ndarray | None"
    spilled_rows: int = 0
    metrics: dict = field(default_factory=dict)
    trace: "list | None" = None

    def top_report(self, k: int) -> str:  # CLI-facing summary
        spill = (f", {self.spilled_rows} rows via disk buckets"
                 if self.spilled_rows else "")
        return (f"sort: {self.n_rows} rows total-ordered across "
                f"{self.n_shards} range(s){spill}")


def run_sort_job(config: JobConfig, on_obs=None) -> SortResult:
    """Total-order sort of a record file: the records through the pair
    collect, one (key, payload) sort on the host or the card, and the
    ordered write.  Beyond-RAM runs demote to the shuffle layer's disk
    buckets and the bucket drain keeps the total order (top-bit ranges +
    per-bucket lexsort)."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "sort"):
        return _run_sort_body(config, obs)


def _run_sort_body(config: JobConfig, obs: Obs) -> SortResult:
    from map_oxidize_tpu_torch.workloads.sort import (
        load_records,
        write_sorted_records,
    )

    metrics = obs.registry
    with obs.phase("sample"):
        # one device: no range splitters; the record count is the
        # conservation check's input
        _keys, _payloads, n_total = load_records(config.input_path)
    engine = _make_engine(config)
    engine.obs = obs
    metrics.set("shuffle/transport", engine.transport)

    with obs.phase("map+route"):
        records, n_chunks = _feed_records(
            config, obs, engine,
            [(config.input_path, lambda p, _path: p.view(np.int64))])

    rows_out = 0
    with obs.phase("merge"):
        if engine.spilled:
            runs = engine.finalize_spilled_runs()
            with host_sort_window(obs):
                if config.output_path:
                    rows_out = write_sorted_records(config.output_path,
                                                    runs)
                else:
                    rows_out = sum(int(k.shape[0]) for k, _d in runs)
        else:
            keys, docs = _finalize_sorted(obs, engine)
            with host_sort_window(obs):
                if config.output_path:
                    rows_out = write_sorted_records(config.output_path,
                                                    [(keys, docs)])
                else:
                    rows_out = int(keys.shape[0])

    # row conservation: a sort loses or invents nothing
    if rows_out != records or records != n_total:
        raise RuntimeError(
            f"sort row conservation violated: {n_total} input rows, "
            f"{records} fed, {rows_out} out")
    metrics.set("records_in", records)
    metrics.set("rows_out", rows_out)
    metrics.set("chunks", n_chunks)
    metrics.set("device_rows_fed", engine.rows_fed)
    summary, trace = obs.finish(config, "sort")
    result = SortResult(n_rows=rows_out, n_shards=1, splitters=None,
                        spilled_rows=int(engine.spilled_rows),
                        metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


# --- hash equi-join --------------------------------------------------------


@dataclass
class JoinResult:
    """Global facts of a hash equi-join; matches stream to
    ``config.output_path`` as 24-byte ``JOIN_REC`` records, lexsorted by
    (key, left payload, right payload)."""

    n_matches: int
    n_left: int
    n_right: int
    n_keys: int
    metrics: dict = field(default_factory=dict)
    trace: "list | None" = None

    def top_report(self, k: int) -> str:
        return (f"join: {self.n_matches} matches from {self.n_left} x "
                f"{self.n_right} rows ({self.n_keys} distinct keys)")


def run_join_job(config: JobConfig, on_obs=None) -> JoinResult:
    """Hash equi-join of ``config.input_path`` (left/build) with
    ``config.join_input_path`` (right/probe) on the record key: both
    corpora go through one pair-collect engine, each key segment comes out
    build-rows-then-probe-rows, and the probe is one vectorized
    cross-product expansion."""
    config.validate()
    if not config.join_input_path:
        raise ValueError(
            "join needs the right-side corpus: --join-input "
            "(config.join_input_path)")
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "join"):
        return _run_join_body(config, obs)


def _run_join_body(config: JobConfig, obs: Obs) -> JoinResult:
    from map_oxidize_tpu_torch.workloads.join import (
        check_join_payloads,
        lexsort_matches,
        probe_join_csr,
        tag_side,
        write_join_records,
    )

    metrics = obs.registry
    engine = _make_engine(config)
    engine.obs = obs
    metrics.set("shuffle/transport", engine.transport)

    sides = {}

    def _doc_fn(right):
        def fn(p, path):
            check_join_payloads(p, path)
            sides[right] = sides.get(right, 0) + int(p.shape[0])
            return tag_side(p, right).view(np.int64)
        return fn

    with obs.phase("map+route"):
        records, n_chunks = _feed_records(
            config, obs, engine,
            [(config.input_path, _doc_fn(False)),
             (config.join_input_path, _doc_fn(True))])

    with obs.phase("merge"):
        terms, offsets, docs, holder = _finalize_grouped(obs, engine)
        with host_sort_window(obs):
            mk, ma, mb = probe_join_csr(terms, offsets, docs)
            mk, ma, mb = lexsort_matches(mk, ma, mb)
        del holder  # the probe consumed the doc column

    with obs.phase("write"):
        if config.output_path:
            write_join_records(config.output_path, mk, ma, mb)

    metrics.set("records_in", records)
    metrics.set("chunks", n_chunks)
    metrics.set("join/matches", int(mk.shape[0]))
    metrics.set("join/left_rows", sides.get(False, 0))
    metrics.set("join/right_rows", sides.get(True, 0))
    metrics.set("distinct_keys", int(terms.shape[0]))
    summary, trace = obs.finish(config, "join")
    result = JoinResult(n_matches=int(mk.shape[0]),
                        n_left=sides.get(False, 0),
                        n_right=sides.get(True, 0),
                        n_keys=int(terms.shape[0]),
                        metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result


# --- sessionize ------------------------------------------------------------


@dataclass
class SessionizeResult:
    """Global facts of a sessionize run; sessions stream to
    ``config.output_path`` as ``key<TAB>start<TAB>end<TAB>count`` lines
    sorted by (key, start)."""

    n_sessions: int
    n_events: int
    n_keys: int
    metrics: dict = field(default_factory=dict)
    trace: "list | None" = None

    def top_report(self, k: int) -> str:
        return (f"sessionize: {self.n_sessions} sessions from "
                f"{self.n_events} events ({self.n_keys} keys)")


def run_sessionize_job(config: JobConfig, on_obs=None) -> SessionizeResult:
    """Gap-cut sessionization of (key, timestamp) events: group by key,
    time-order each key's events through the engine's (key, ts) sort, cut
    sessions wherever the gap exceeds ``config.session_gap``."""
    config.validate()
    obs = Obs.from_config(config)
    if on_obs is not None:
        on_obs(obs)
    with obs.recording(config, "sessionize"):
        return _run_sessionize_body(config, obs)


def _run_sessionize_body(config: JobConfig, obs: Obs) -> SessionizeResult:
    from map_oxidize_tpu_torch.workloads.sessionize import (
        sessions_from_csr,
        sort_sessions,
        write_sessions,
    )

    metrics = obs.registry
    engine = _make_engine(config)
    engine.obs = obs
    metrics.set("shuffle/transport", engine.transport)

    with obs.phase("map+route"):
        records, n_chunks = _feed_records(
            config, obs, engine,
            [(config.input_path, lambda p, _path: p.view(np.int64))])

    with obs.phase("merge"):
        terms, offsets, docs, holder = _finalize_grouped(obs, engine)
        with host_sort_window(obs):
            sk, ss, se, sc = sessions_from_csr(terms, offsets, docs,
                                               config.session_gap)
            sk, ss, se, sc = sort_sessions(sk, ss, se, sc)
        del holder

    # event conservation: every event lands in exactly one session
    if int(sc.sum()) != records:
        raise RuntimeError(
            f"sessionize event conservation violated: {records} events "
            f"fed, sessions cover {int(sc.sum())}")

    with obs.phase("write"):
        if config.output_path:
            write_sessions(config.output_path, sk, ss, se, sc)

    metrics.set("records_in", records)
    metrics.set("chunks", n_chunks)
    metrics.set("sessions/count", int(sk.shape[0]))
    metrics.set("distinct_keys", int(terms.shape[0]))
    summary, trace = obs.finish(config, "sessionize")
    result = SessionizeResult(n_sessions=int(sk.shape[0]),
                              n_events=records,
                              n_keys=int(terms.shape[0]),
                              metrics=summary, trace=trace)
    if config.metrics:
        _log.info("metrics: %s", result.metrics)
    return result
