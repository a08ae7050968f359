"""Causal critical-path observatory: cross-process blame, slack, what-if.
The port of the JAX package's ``obs/critpath.py`` (855 lines, whole), in
the same ``moxt-critpath-v1`` document.

The happens-before span DAG is built from the merged distributed trace:
**program edges** (per-thread span order within a process), **handoff
edges** (producer->consumer queue handoffs joined on ``seq=`` tags) and
**barrier edges** (every lockstep collective round, joined on the
``round=`` tags the ``parallel/`` drivers stamp on their
``dist/lockstep_flag`` and ``dist/merge_local`` spans: no process leaves
round *k* before the LAST process enters it).  The critical path walks
back from the last-finishing process through the barrier chain, jumping
at each barrier to the process that arrived last, so it tiles the traced
wall into per-process work intervals (sub-attributed onto the attribution
bucket names), on-path collective latency and startup skew.  From the same
round model: **blame shares** per process, **slack** (the sum of a
process's barrier waits) and the **what-if** replays ("process *i* at
peer-median speed", "map/shuffle perfectly overlapped", "collectives
free").

Surfaces: ``obs critpath``, the ``critpath`` section of the merged-trace
skew report and of the metrics document, and the headline ``critpath/*``
gauges.  A single-process job has no cross-process DAG: its path
degenerates to the attribution timeline (:func:`degenerate_from_attrib`),
in the same document shape, which ``Obs.finish`` publishes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CRITPATH_SCHEMA = "moxt-critpath-v1"

#: clock-alignment refusal bound (seconds): after wall-clock alignment,
#: every process is INSIDE a lockstep barrier round simultaneously at
#: some instant — a round whose last arrival lands after another
#: process's exit by more than this is wall-clock skew, and merging it
#: would silently mis-order every cross-process edge
CLOCK_SKEW_BOUND_S = 2.0

#: span-name -> attrib-bucket classification for on-path work segments,
#: checked in order (first match wins; specific names before phase
#: containers).  Buckets reuse the attribution ledger's names where the
#: meaning matches (docs/OBSERVABILITY.md "Where did the time go");
#: ``exchange`` is new — the lockstep all_to_all exchange rounds, the
#: time the "map/shuffle overlapped" what-if hides behind map work.
_SPAN_BUCKETS: tuple[tuple[str, str], ...] = (
    ("dist/merge_local", "exchange"),
    ("dist/map_chunk", "host_produce"),
    # push-edge handoffs (the pipelined shuffle transport): map runs on
    # the prefetcher thread as push/produce while the lockstep exchange
    # occupies the driver, and push/feed_wait is the residue the overlap
    # did NOT hide.  Once a run is pushed, the map_shuffle_overlapped
    # what-if prices only that residue — its predicted saving
    # approaching zero is the banked-overlap signal, not a regression.
    ("push/produce", "host_produce"),
    ("push/feed_wait", "feed_wait"),
    ("shuffle/remote_stage", "spill_io"),
    ("shuffle/demote", "spill_io"),
    ("engine/flush", "host_stage"),
    ("engine/feed_block", "host_stage"),
    ("phase/sample", "host_produce"),
    ("phase/split", "host_produce"),
    ("phase/write", "host_write"),
    ("phase/finalize", "finalize"),
    ("phase/merge", "finalize"),
)
#: suffix-matched handoff spans (the prefetcher names are
#: ``<pipeline-name>/produce`` / ``<pipeline-name>/feed_wait``)
_SPAN_SUFFIX_BUCKETS: tuple[tuple[str, str], ...] = (
    ("/feed_wait", "feed_wait"),
    ("/produce", "host_produce"),
)

#: the what-if names (stable identifiers tests and docs reference)
WHATIF_PROC_MEDIAN = "proc_{p}_at_peer_median_speed"
WHATIF_OVERLAP = "map_shuffle_overlapped"
WHATIF_FREE_COLLECTIVES = "collectives_free"


class ClockSkewError(ValueError):
    """Shard wall clocks disagree beyond :data:`CLOCK_SKEW_BOUND_S`:
    after alignment, a lockstep barrier round's spans do not overlap
    across processes.  Merging/critpathing would silently mis-order
    every cross-process edge, so the caller must refuse (or re-align
    with trusted clocks)."""


@dataclass
class ProcTimeline:
    """One process's aligned trace view: complete (``ph="X"``) spans on
    a shared global time axis (microseconds since the earliest shard's
    wall start), the lockstep barrier rounds extracted from the
    ``round=`` tags, and the shard's attribution document when the
    shard carried one."""

    process: int
    spans: list = field(default_factory=list)   # (name, t0, t1, tid, args)
    rounds: dict = field(default_factory=dict)  # round -> (enter, exit) us
    attrib: dict | None = None
    wall_start_unix_s: float = 0.0

    @property
    def start_us(self) -> float:
        return min((s[1] for s in self.spans), default=0.0)

    @property
    def end_us(self) -> float:
        return max((s[2] for s in self.spans), default=0.0)


# --- timeline construction -------------------------------------------------


def _push_span(tl: ProcTimeline, name: str, t0: float, dur: float,
               tid, args: dict) -> None:
    t1 = t0 + max(dur, 0.0)
    tl.spans.append((name, t0, t1, tid, args))
    if name == "dist/lockstep_flag":
        r = args.get("round")
        if isinstance(r, int) and r not in tl.rounds:
            tl.rounds[r] = (t0, t1)


def timelines_from_shards(shards: list[dict]) -> list[ProcTimeline]:
    """Per-process timelines from shard documents (``moxt-obs-shard-v1``),
    aligned exactly the way :func:`map_oxidize_tpu_torch.obs.merge.merge_shards`
    aligns the merged Chrome trace: each shard's events shift by its
    wall-clock anchor relative to the earliest shard.  Refuses (named
    ``ValueError``) a shard whose wall anchor is missing or non-positive
    — an un-anchorable shard cannot join a shared time axis."""
    tls: list[ProcTimeline] = []
    anchors = []
    for s in shards:
        meta = s.get("meta", {})
        ws = meta.get("wall_start_unix_s")
        if not isinstance(ws, (int, float)) or not ws > 0:
            raise ValueError(
                f"shard for process {meta.get('process')!r} has no usable "
                f"wall_start_unix_s anchor ({ws!r}): cannot align it onto "
                "the shared time axis")
        anchors.append(float(ws))
    anchor = min(anchors)
    for s, ws in zip(shards, anchors):
        meta = s.get("meta", {})
        tl = ProcTimeline(process=int(meta.get("process", 0)),
                          attrib=(s.get("metrics") or {}).get("attrib"),
                          wall_start_unix_s=ws)
        shift = (ws - anchor) * 1e6
        for e in s.get("events", []):
            if e.get("ph") != "X":
                continue
            _push_span(tl, e.get("name", ""), float(e.get("ts", 0.0))
                       + shift, float(e.get("dur", 0.0)), e.get("tid"),
                       e.get("args") or {})
        tls.append(tl)
    tls.sort(key=lambda t: t.process)
    return tls


def timelines_from_merged_events(events: list[dict]) -> list[ProcTimeline]:
    """Per-process timelines from an already-merged Chrome trace (the
    ``obs merge`` artifact: ``pid`` = process slot, timestamps already
    on the shared axis)."""
    by_pid: dict[int, ProcTimeline] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        p = int(e.get("pid", 0))
        tl = by_pid.get(p)
        if tl is None:
            tl = by_pid[p] = ProcTimeline(process=p)
        _push_span(tl, e.get("name", ""), float(e.get("ts", 0.0)),
                   float(e.get("dur", 0.0)), e.get("tid"),
                   e.get("args") or {})
    return [by_pid[p] for p in sorted(by_pid)]


def common_rounds(timelines: list[ProcTimeline]) -> list[int]:
    """Barrier rounds every covered process recorded (a killed process's
    partial shard truncates the common set — the coverage gap the report
    names)."""
    if not timelines:
        return []
    rounds = set(timelines[0].rounds)
    for tl in timelines[1:]:
        rounds &= set(tl.rounds)
    return sorted(rounds)


def check_clock_alignment(timelines: list[ProcTimeline],
                          bound_s: float = CLOCK_SKEW_BOUND_S) -> None:
    """Causal clock-skew check over the barrier rounds: for every common
    round, the last arrival must not land after any process's exit by
    more than ``bound_s`` (barrier semantics — everyone is inside the
    round simultaneously; only wall-clock skew can violate that).
    Raises :class:`ClockSkewError` naming the worst round."""
    worst = (0.0, None)
    for r in common_rounds(timelines):
        max_enter = max(tl.rounds[r][0] for tl in timelines)
        min_exit = min(tl.rounds[r][1] for tl in timelines)
        skew = (max_enter - min_exit) / 1e6
        if skew > worst[0]:
            worst = (skew, r)
    if worst[1] is not None and worst[0] > bound_s:
        raise ClockSkewError(
            f"wall-clock skew {worst[0]:.3f}s at lockstep round "
            f"{worst[1]} exceeds the {bound_s:g}s alignment bound: after "
            "wall-clock alignment a barrier round's spans must overlap "
            "across processes; refusing to mis-order cross-process edges "
            "(fix the hosts' clocks, or re-export with aligned anchors)")


# --- interval classification -----------------------------------------------


def _bucket_of(name: str) -> str | None:
    for prefix, bucket in _SPAN_BUCKETS:
        if name.startswith(prefix):
            return bucket
    for suffix, bucket in _SPAN_SUFFIX_BUCKETS:
        if name.endswith(suffix):
            return bucket
    return None


def _classify_interval(tl: ProcTimeline, t0: float, t1: float) -> dict:
    """Sub-attribute one work interval ``[t0, t1]`` on ``tl`` onto the
    attrib bucket names by span overlap.  Buckets claim time in
    :data:`_SPAN_BUCKETS` priority order over a covered-interval list,
    so nested spans (a ``dist/map_chunk`` inside ``phase/map+reduce``)
    never double-count; the unclaimed remainder is ``other``.  Returns
    ``{bucket: ms}``."""
    if t1 <= t0:
        return {}
    by_bucket: dict[str, list] = {}
    for name, s0, s1, _tid, _args in tl.spans:
        b = _bucket_of(name)
        if b is None:
            continue
        lo, hi = max(s0, t0), min(s1, t1)
        if hi > lo:
            by_bucket.setdefault(b, []).append((lo, hi))
    covered: list[tuple[float, float]] = []
    out: dict[str, float] = {}
    order = [b for _p, b in _SPAN_BUCKETS] + [b for _s, b
                                              in _SPAN_SUFFIX_BUCKETS]
    seen = set()
    for bucket in order:
        if bucket in seen or bucket not in by_bucket:
            seen.add(bucket)
            continue
        seen.add(bucket)
        got = 0.0
        for lo, hi in _merge_intervals(by_bucket[bucket]):
            got += _uncovered(lo, hi, covered)
            covered = _merge_intervals(covered + [(lo, hi)])
        if got > 0:
            out[bucket] = out.get(bucket, 0.0) + got / 1e3
    claimed = sum(hi - lo for lo, hi in covered)
    other = (t1 - t0) - claimed
    if other > 0:
        out["other"] = other / 1e3
    return out


def _merge_intervals(ivs: list) -> list:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [ivs[0]]
    for lo, hi in ivs[1:]:
        if lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _uncovered(lo: float, hi: float, covered: list) -> float:
    """Length of [lo, hi] not already claimed by ``covered`` (a sorted,
    disjoint interval list)."""
    got = hi - lo
    for c0, c1 in covered:
        o_lo, o_hi = max(lo, c0), min(hi, c1)
        if o_hi > o_lo:
            got -= o_hi - o_lo
    return max(got, 0.0)


# --- the round model + replay ----------------------------------------------


@dataclass
class _RoundModel:
    """The barrier-structured execution model extracted from the
    timelines — the inputs the deterministic what-if replay runs on."""

    procs: list[int]
    rounds: list[int]
    start_s: dict        # proc -> start offset from job start (s)
    work_s: dict         # proc -> [interval duration per round] (s)
    coll_s: list         # per-round collective latency (s)
    tail_s: dict         # proc -> after-last-round tail (s)
    #: per-(proc, round) bucket decomposition of the interval, {bkt: ms}
    buckets: dict


def _extract_model(timelines: list[ProcTimeline],
                   rounds: list[int]) -> _RoundModel:
    job_start = min(tl.start_us for tl in timelines)
    procs = [tl.process for tl in timelines]
    start_s, work_s, tail_s, buckets = {}, {}, {}, {}
    coll_s = []
    for tl in timelines:
        p = tl.process
        start_s[p] = (tl.start_us - job_start) / 1e6
        prev_exit = tl.start_us
        ws = []
        for i, r in enumerate(rounds):
            enter, exit_ = tl.rounds[r]
            ws.append(max(enter - prev_exit, 0.0) / 1e6)
            buckets[(p, i)] = _classify_interval(tl, prev_exit, enter)
            prev_exit = exit_
        work_s[p] = ws
        tail_s[p] = max(tl.end_us - prev_exit, 0.0) / 1e6
        buckets[(p, len(rounds))] = _classify_interval(tl, prev_exit,
                                                       tl.end_us)
    for r in rounds:
        arrive = max(tl.rounds[r][0] for tl in timelines)
        mean_exit = (sum(tl.rounds[r][1] for tl in timelines)
                     / len(timelines))
        coll_s.append(max(mean_exit - arrive, 0.0) / 1e6)
    return _RoundModel(procs=procs, rounds=rounds, start_s=start_s,
                       work_s=work_s, coll_s=coll_s, tail_s=tail_s,
                       buckets=buckets)


def _replay(model: _RoundModel, start_s=None, work_s=None, coll_s=None,
            tail_s=None) -> float:
    """Deterministic barrier-schedule replay: wall (seconds) of the
    round model under (possibly counterfactual) inputs.  Every process
    runs its interval work, the round completes when the LAST arrives
    plus the collective latency, everyone leaves together — the same
    lockstep semantics the real drivers implement."""
    start_s = model.start_s if start_s is None else start_s
    work_s = model.work_s if work_s is None else work_s
    coll_s = model.coll_s if coll_s is None else coll_s
    tail_s = model.tail_s if tail_s is None else tail_s
    avail = dict(start_s)
    for i in range(len(model.rounds)):
        arrive = max(avail[p] + work_s[p][i] for p in model.procs)
        done = arrive + coll_s[i]
        avail = {p: done for p in model.procs}
    return max(avail[p] + tail_s[p] for p in model.procs)


def _median(vals: list[float]) -> float:
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return 0.0
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


# --- the report ------------------------------------------------------------


def compute(timelines: list[ProcTimeline],
            coverage: dict | None = None) -> dict:
    """The critical-path document from >= 2 aligned process timelines.
    Raises ``ValueError`` when no common lockstep rounds exist (nothing
    to anchor cross-process edges on)."""
    if len(timelines) < 2:
        raise ValueError(
            "critical-path extraction needs >= 2 process timelines; a "
            "single-process job degenerates to the attribution timeline "
            "(degenerate_from_attrib)")
    rounds = common_rounds(timelines)
    if not rounds:
        raise ValueError(
            "no common lockstep rounds across process timelines — the "
            "trace predates round tagging, or the shards are not one "
            "job's")
    model = _extract_model(timelines, rounds)
    by_proc = {tl.process: tl for tl in timelines}
    job_start = min(tl.start_us for tl in timelines)
    job_end = max(tl.end_us for tl in timelines)
    wall_ms = (job_end - job_start) / 1e3

    # --- DAG bookkeeping (counts; the path extraction below IS the
    # longest-path walk over these edges)
    n_program_edges = 0
    n_handoff = 0
    for tl in timelines:
        per_thread: dict = {}
        produce_seqs: dict = {}
        wait_seqs = set()
        for name, _t0, _t1, tid, args in tl.spans:
            per_thread[tid] = per_thread.get(tid, 0) + 1
            seq = args.get("seq")
            if isinstance(seq, int):
                if name.endswith("/produce"):
                    produce_seqs[seq] = True
                elif name.endswith("/feed_wait"):
                    wait_seqs.add(seq)
        n_program_edges += sum(max(n - 1, 0) for n in per_thread.values())
        n_handoff += len(wait_seqs & set(produce_seqs))
    n_barrier_edges = len(rounds) * len(timelines) * 2  # in + out per proc

    # --- critical path: walk back from the last-finishing process
    # through the barrier chain (the binding process of round r is the
    # LAST arrival — the longest-path predecessor through the barrier)
    segments: list[dict] = []
    cur = max(timelines, key=lambda t: t.end_us).process
    T = job_end

    def _work_seg(p: int, t0: float, t1: float, interval: int,
                  kind: str = "work"):
        if t1 - t0 <= 0:
            return
        segments.append({
            "kind": kind, "process": p,
            "round": (rounds[interval] if interval < len(rounds)
                      else None),
            "ms": round((t1 - t0) / 1e3, 3),
            "t0_ms": round((t0 - job_start) / 1e3, 3),
            "buckets": {k: round(v, 3) for k, v in sorted(
                model.buckets.get((p, interval), {}).items())},
        })

    # tail: after the last common round on the path-ending process
    _work_seg(cur, by_proc[cur].rounds[rounds[-1]][1], T, len(rounds),
              kind="tail")
    for i in range(len(rounds) - 1, -1, -1):
        r = rounds[i]
        binder = max(timelines, key=lambda t: t.rounds[r][0]).process
        arrive = by_proc[binder].rounds[r][0]
        exit_cur = by_proc[cur].rounds[r][1]
        if exit_cur > arrive:
            segments.append({
                "kind": "collective", "process": None, "round": r,
                "ms": round((exit_cur - arrive) / 1e3, 3),
                "t0_ms": round((arrive - job_start) / 1e3, 3),
                "binder": binder,
            })
        cur = binder
        t0 = (by_proc[cur].rounds[rounds[i - 1]][1] if i > 0
              else by_proc[cur].start_us)
        _work_seg(cur, t0, arrive, i)
    if by_proc[cur].start_us > job_start:
        segments.append({
            "kind": "startup", "process": cur, "round": None,
            "ms": round((by_proc[cur].start_us - job_start) / 1e3, 3),
            "t0_ms": 0.0,
        })
    segments.reverse()
    path_ms = sum(s["ms"] for s in segments)

    # --- blame: each process's share of the on-path work
    blame_ms: dict[int, float] = {tl.process: 0.0 for tl in timelines}
    for s in segments:
        if s["kind"] in ("work", "tail", "startup"):
            blame_ms[s["process"]] += s["ms"]
    work_total = sum(blame_ms.values())
    blame = {
        str(p): {"on_path_ms": round(ms, 3),
                 "share_pct": round(100.0 * ms / work_total, 2)
                 if work_total else 0.0}
        for p, ms in sorted(blame_ms.items())}

    # --- slack: how much this process could slow down for free.  Every
    # barrier RESYNCHRONIZES the fleet, so each round's wait absorbs
    # slowdown of the interval feeding that round independently — the
    # process's total free slowdown is the SUM of its barrier waits
    # (distributed as those waits; a straggler that binds every round
    # has none).  ``binding_round`` names the first round whose wait is
    # ~zero (where more slowdown would start moving the wall), and
    # ``end_gap_ms`` is the separate tail headroom (how much its
    # post-barrier tail could stretch before setting the job end).
    slack = {}
    for tl in timelines:
        waits = [max((max(t2.rounds[r][0] for t2 in timelines)
                      - tl.rounds[r][0]) / 1e3, 0.0) for r in rounds]
        binding = rounds[waits.index(min(waits))]
        slack[str(tl.process)] = {
            "slack_ms": round(sum(waits), 3),
            "binding_round": binding,
            "end_gap_ms": round(max((job_end - tl.end_us) / 1e3, 0.0),
                                3)}

    coll_on_path = sum(s["ms"] for s in segments
                       if s["kind"] == "collective")

    # --- what-if estimators: deterministic replay of the round model
    base_wall_s = _replay(model)
    what_if = []
    for tl in timelines:
        p = tl.process
        others = [q for q in model.procs if q != p]
        w2 = dict(model.work_s)
        w2[p] = [_median([model.work_s[q][i] for q in others])
                 for i in range(len(rounds))]
        t2 = dict(model.tail_s)
        t2[p] = _median([model.tail_s[q] for q in others])
        s2 = dict(model.start_s)
        s2[p] = _median([model.start_s[q] for q in others])
        est = _replay(model, start_s=s2, work_s=w2, tail_s=t2)
        what_if.append(_whatif_row(
            WHATIF_PROC_MEDIAN.format(p=p), base_wall_s, est,
            f"process {p} at the peer-median speed per round"))
    # map/shuffle overlapped: each interval's exchange time hides
    # behind its map/produce time (the pipelined-transport bound)
    w_ov = {}
    for p in model.procs:
        ws = []
        for i, w in enumerate(model.work_s[p]):
            b = model.buckets.get((p, i), {})
            hidden = min(b.get("exchange", 0.0),
                         b.get("host_produce", 0.0)) / 1e3
            ws.append(max(w - hidden, 0.0))
        w_ov[p] = ws
    what_if.append(_whatif_row(
        WHATIF_OVERLAP, base_wall_s, _replay(model, work_s=w_ov),
        "per-round exchange wall hidden behind map production "
        "(pipelined shuffle upper bound)"))
    what_if.append(_whatif_row(
        WHATIF_FREE_COLLECTIVES, base_wall_s,
        _replay(model, coll_s=[0.0] * len(rounds)),
        "lockstep collective latency taken to zero"))
    what_if.sort(key=lambda w: -w["est_delta_ms"])

    top_p, top_row = max(blame.items(),
                         key=lambda kv: kv[1]["share_pct"])
    top_buckets: dict[str, float] = {}
    for s in segments:
        if s["kind"] in ("work", "tail") and str(s["process"]) == top_p:
            for k, v in (s.get("buckets") or {}).items():
                top_buckets[k] = top_buckets.get(k, 0.0) + v
    top_bucket = max(top_buckets, key=top_buckets.get) \
        if top_buckets else "work"
    doc = {
        "schema": CRITPATH_SCHEMA,
        "n_processes": len(timelines),
        "rounds": len(rounds),
        "wall_ms": round(wall_ms, 3),
        "path_ms": round(path_ms, 3),
        "path_over_wall_pct": round(100.0 * path_ms
                                    / max(wall_ms, 1e-9), 2),
        "model_wall_ms": round(base_wall_s * 1e3, 3),
        "model_error_pct": round(
            100.0 * abs(base_wall_s * 1e3 - wall_ms)
            / max(wall_ms, 1e-9), 2),
        "dag": {"nodes": sum(len(tl.spans) for tl in timelines),
                "edges": {"program": n_program_edges,
                          "barrier": n_barrier_edges,
                          "handoff": n_handoff}},
        "segments": segments,
        "blame": blame,
        "slack": slack,
        "collective_wait": {
            "on_path_ms": round(coll_on_path, 3),
            "share_pct": round(100.0 * coll_on_path
                               / max(path_ms, 1e-9), 2)},
        "what_if": what_if,
        "bound_by": f"proc {top_p} {top_bucket} "
                    f"({top_row['share_pct']:.0f}% blame)",
    }
    if coverage:
        doc["coverage"] = coverage
    return doc


def _whatif_row(name: str, base_s: float, est_s: float,
                description: str) -> dict:
    delta = max(base_s - est_s, 0.0)
    return {
        "name": name,
        "est_wall_ms": round(est_s * 1e3, 3),
        "est_delta_ms": round(delta * 1e3, 3),
        "est_delta_pct": round(100.0 * delta / max(base_s, 1e-9), 2),
        "description": description,
    }


def check_shard_identity(shards: list[dict]) -> None:
    """Mixed-identity or duplicate-slot shards are not one job: blending
    them (stale ``.proc2``/``.proc3`` next to a fresh 2-proc rerun, two
    copies of one slot) would produce a silently cross-job causal
    report.  Same refusal semantics as ``obs merge``."""
    metas = [s.get("meta", {}) for s in shards]
    ident = {(m.get("config_hash"), m.get("workload")) for m in metas}
    if len(ident) > 1:
        raise ValueError(
            f"shards disagree on (config_hash, workload): {sorted(ident)}"
            " — they are not shards of one job (remove stale .proc<i> "
            "files from an earlier run)")
    seen = [m.get("process") for m in metas]
    if len(set(seen)) != len(seen):
        raise ValueError(f"duplicate process slots in shards: {seen}")


def compute_from_shards(shards: list[dict], coverage: dict | None = None,
                        check_clock: bool = True) -> dict:
    """Critical path from shard documents: identity-check, align,
    clock-check, extract.  A single available shard degenerates to its
    attribution timeline (the named coverage gap rides the document)."""
    check_shard_identity(shards)
    tls = timelines_from_shards(shards)
    if check_clock:
        check_clock_alignment(tls)
    if len(tls) == 1:
        doc = degenerate_from_attrib(
            tls[0].attrib, process=tls[0].process)
        if coverage:
            doc["coverage"] = coverage
        return doc
    return compute(tls, coverage=coverage)


def compute_from_merged_events(events: list[dict]) -> dict:
    """Critical path from an already-merged Chrome trace (``obs merge``
    output; clock alignment already applied and checked at merge
    time)."""
    return compute(timelines_from_merged_events(events))


def degenerate_from_attrib(attrib_doc: dict | None,
                           process: int = 0) -> dict:
    """The single-process (single-chip) form: no cross-process DAG
    exists, so the path IS the attribution timeline — one segment per
    attrib bucket, blame 100% on the one process, no slack, and the
    feed-wait bucket as the overlap what-if (the part of host produce
    the pipeline did not hide)."""
    if not attrib_doc:
        raise ValueError(
            "no attribution document to degenerate onto (run with "
            "metrics enabled, or give a merged multi-process trace)")
    wall_ms = float(attrib_doc.get("wall_ms", 0.0))
    buckets = {name: float(row.get("ms", 0.0))
               for name, row in (attrib_doc.get("buckets") or {}).items()
               if row.get("ms")}
    attributed = sum(buckets.values())
    segments = [{"kind": "work", "process": process, "round": None,
                 "ms": round(ms, 3), "buckets": {name: round(ms, 3)}}
                for name, ms in sorted(buckets.items(),
                                       key=lambda kv: -kv[1])]
    top = max(buckets, key=buckets.get) if buckets else "unattributed"
    coll_ms = buckets.get("collective_wait", 0.0)
    feed_wait = buckets.get("feed_wait", 0.0)
    base_s = wall_ms / 1e3
    what_if = [_whatif_row(
        WHATIF_OVERLAP, base_s, (wall_ms - feed_wait) / 1e3,
        "pipeline feed waits fully hidden behind consumer work")]
    return {
        "schema": CRITPATH_SCHEMA,
        "n_processes": 1,
        "rounds": 0,
        "wall_ms": round(wall_ms, 3),
        "path_ms": round(attributed, 3),
        "path_over_wall_pct": round(100.0 * attributed
                                    / max(wall_ms, 1e-9), 2),
        "degenerate": "attrib-timeline",
        "segments": segments,
        "blame": {str(process): {"on_path_ms": round(attributed, 3),
                                 "share_pct": 100.0}},
        "slack": {},
        "collective_wait": {
            "on_path_ms": round(coll_ms, 3),
            "share_pct": round(100.0 * coll_ms
                               / max(attributed, 1e-9), 2)},
        "what_if": what_if,
        "bound_by": f"{top} "
                    f"({100.0 * buckets.get(top, 0.0) / max(wall_ms, 1e-9):.0f}% of wall)"
                    if buckets else "unattributed",
    }


# --- headline gauges + publication -----------------------------------------


def headline(doc: dict) -> dict:
    """The flat ``critpath/*`` gauges ledger entries carry (what
    ``obs diff --gate`` and ``obs trend`` watch, and what the
    ``critpath-process-blame`` SLO rule fires on)."""
    blame = doc.get("blame") or {}
    top_share = max((row.get("share_pct", 0.0) for row in blame.values()),
                    default=0.0)
    slack = doc.get("slack") or {}
    top_slack = max((row.get("slack_ms", 0.0) for row in slack.values()),
                    default=0.0)
    if doc.get("degenerate"):
        # single process: every path is 100% "this process", so the
        # bound fraction is the DOMINANT COST's share of wall instead
        # (the largest attrib bucket — what bound_by names)
        wall = float(doc.get("wall_ms") or 0.0)
        top_ms = max((s.get("ms", 0.0)
                      for s in doc.get("segments") or []), default=0.0)
        bound_frac = top_ms / wall if wall else 0.0
    else:
        bound_frac = top_share / 100.0
    out = {
        "critpath/bound_frac": round(bound_frac, 4),
        "critpath/top_process_slack_ms": round(top_slack, 3),
        "critpath/collective_wait_share_pct":
            (doc.get("collective_wait") or {}).get("share_pct", 0.0),
        "critpath/path_over_wall_pct": doc.get("path_over_wall_pct", 0.0),
        "critpath/bound_by": doc.get("bound_by", "?"),
    }
    if isinstance(doc.get("model_error_pct"), (int, float)):
        # the what-if replay's fidelity number, ledger-visible so
        # replay-model error and the planner's plan/model_error_pct
        # trend side by side (obs trend ranks both up-is-bad).  The
        # degenerate single-process doc never replays, so it carries
        # no error to publish
        out["critpath/model_error_pct"] = doc["model_error_pct"]
    if doc.get("n_processes", 1) > 1:
        # the process-blame share only exists where processes exist —
        # the degenerate single-chip form must NOT publish either gauge
        out["critpath/top_blame_share"] = round(top_share / 100.0, 4)
        # the robust straggler signal the SLO rule watches: the largest
        # "this process at peer-median speed" saving, as a fraction of
        # the wall.  Raw path ownership concentrates on the marginal
        # binder even when arrivals near-tie (a healthy 2-proc compile
        # round reads 99% blame on a coin-flip binder); the replay
        # saving is ~0 on a tie and large only when fixing ONE process
        # would actually move the wall — which is what "straggler on
        # the critical path" means
        save = max((w.get("est_delta_pct", 0.0)
                    for w in doc.get("what_if") or []
                    if w.get("name", "").startswith("proc_")),
                   default=0.0)
        out["critpath/straggler_save_frac"] = round(save / 100.0, 4)
    return out


def publish(registry, doc: dict) -> dict:
    """Set the headline gauges on a job registry (they ride the summary
    into the ledger entry, ``/metrics``, BENCH_DETAIL, and — after a
    final series sample — the SLO evaluator).  Returns the gauge map."""
    gauges = headline(doc)
    for k, v in gauges.items():
        registry.set(k, v)
    return gauges


# --- rendering -------------------------------------------------------------


def render(doc: dict, title: str = "critical path") -> str:
    """Human-readable report (the ``obs critpath`` stdout).  Pure, so
    tests pin it without artifacts."""
    wall_s = doc.get("wall_ms", 0.0) / 1e3
    lines = [f"{title}: wall {wall_s:.3f}s, path covers "
             f"{doc.get('path_over_wall_pct', 0.0):.1f}% "
             f"({doc.get('n_processes', 1)} process(es), "
             f"{doc.get('rounds', 0)} lockstep rounds)"]
    lines.append(f"bound by: {doc.get('bound_by', '?')}")
    cov = doc.get("coverage")
    if cov:
        missing = cov.get("missing_processes") or []
        torn = cov.get("torn_shards") or []
        if missing or torn:
            lines.append(
                "!! coverage gap: "
                + (f"missing shard(s) for process(es) {missing}"
                   if missing else "")
                + (" and " if missing and torn else "")
                + (f"torn shard(s) {torn}" if torn else "")
                + " — path computed from the surviving processes")
    blame = doc.get("blame") or {}
    if blame:
        lines.append("blame (share of on-path work):")
        for p, row in sorted(blame.items(),
                             key=lambda kv: -kv[1]["share_pct"]):
            bar = "#" * min(int(round(row["share_pct"] / 2.5)), 40)
            lines.append(f"  proc {p:<3} {row['on_path_ms'] / 1e3:>9.3f}s "
                         f"{row['share_pct']:>5.1f}%  {bar}")
    cw = doc.get("collective_wait") or {}
    if cw:
        lines.append(f"on-path collective wait: "
                     f"{cw.get('on_path_ms', 0.0) / 1e3:.3f}s "
                     f"({cw.get('share_pct', 0.0):.1f}% of path)")
    slack = doc.get("slack") or {}
    if slack:
        lines.append("slack (how much each process could slow for free, "
                     "distributed as its barrier waits):")
        for p, row in sorted(slack.items()):
            b = row.get("binding_round")
            lines.append(
                f"  proc {p:<3} {row['slack_ms'] / 1e3:>9.3f}s  "
                f"(tightest at round {b}; tail headroom "
                f"{row.get('end_gap_ms', 0.0) / 1e3:.3f}s)")
    what_if = doc.get("what_if") or []
    if what_if:
        lines.append("what-if (deterministic replay of the round model):")
        for w in what_if[:6]:
            lines.append(
                f"  {w['name']:<34} wall -{w['est_delta_pct']:>5.1f}% "
                f"(-{w['est_delta_ms'] / 1e3:.3f}s) — {w['description']}")
    segs = doc.get("segments") or []
    if segs and not doc.get("degenerate"):
        lines.append(f"path segments ({len(segs)}):")
        for s in segs[:24]:
            who = ("collective" if s["kind"] == "collective"
                   else f"proc {s['process']} {s['kind']}")
            b = s.get("buckets") or {}
            top = (" [" + ", ".join(
                f"{k} {v / 1e3:.2f}s" for k, v in sorted(
                    b.items(), key=lambda kv: -kv[1])[:3]) + "]"
                if b else "")
            r = f" r{s['round']}" if s.get("round") is not None else ""
            lines.append(f"  {s['ms'] / 1e3:>8.3f}s  {who}{r}{top}")
        if len(segs) > 24:
            lines.append(f"  ... {len(segs) - 24} more")
    elif doc.get("degenerate"):
        lines.append("(single process: path degenerates to the "
                     "attribution timeline)")
        for s in segs[:12]:
            name = next(iter(s.get("buckets") or {"work": 0}))
            lines.append(f"  {s['ms'] / 1e3:>8.3f}s  {name}")
    return "\n".join(lines)
