"""Cross-process trace/metrics shards and their merger.  The port of the
JAX package's ``obs/merge.py`` (whole), in its ``moxt-obs-shard-v1``
schema, so either package's ``obs merge`` reads the other's shards.

A multi-process job has no single tracer: each process records its own
spans and counters against its own clock, and writes one *shard* — the
run metadata (version, config hash, workload, process slot, wall-clock
anchor), its Chrome trace events and its full metrics document.
:func:`merge_shards` combines them into one Chrome trace (``pid`` = the
process slot, timestamps aligned on each shard's wall anchor) and a skew
report (per-process rows, records and bytes, collective wait against
work, and a straggler ranking).

Shards are named ``<trace_out>.proc<i>``; process 0 merges them at job
end when they share a filesystem, and ``python -m map_oxidize_tpu_torch
obs merge`` does the same by hand.
"""

from __future__ import annotations

import glob
import json
import os

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

SHARD_SCHEMA = "moxt-obs-shard-v1"

#: span names that are cross-process *waiting*, not work: time here is
#: time blocked on the slowest participant (the straggler signal)
WAIT_SPAN_PREFIXES = ("dist/lockstep_flag",)
#: span names that are this process's own work
WORK_SPAN_PREFIXES = ("dist/map_chunk", "dist/merge_local",
                      "engine/feed_block", "engine/flush", "phase/replay")


def shard_path(trace_out: str, process: int) -> str:
    return f"{trace_out}.proc{process}"


def write_shard(path: str, meta: dict, events: list[dict],
                metrics: dict) -> None:
    """One process's shard: metadata + its Chrome events + its metrics
    document, written atomically (same contract as every artifact
    writer in the repo)."""
    from map_oxidize_tpu_torch.obs import write_json_atomic

    write_json_atomic(path, {
        "schema": SHARD_SCHEMA,
        "meta": meta,
        "events": events,
        "metrics": metrics,
    }, indent=None)


def read_shard(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SHARD_SCHEMA:
        raise ValueError(
            f"{path} is not an obs shard (schema={doc.get('schema')!r}); "
            "expected a <trace_out>.proc<i> file from a distributed run")
    return doc


def read_shards_tolerant(paths: list[str]
                         ) -> "tuple[list[dict], list[dict]]":
    """Read every shard that parses; a torn/garbage shard (a killed
    process's partial write, a truncated copy) is collected as a NAMED
    coverage gap instead of aborting the merge — a post-mortem must
    reconstruct what survived, not refuse because something died.
    Returns ``(shards, torn)`` where each torn row is
    ``{"path", "error"}``."""
    shards: list[dict] = []
    torn: list[dict] = []
    for p in paths:
        try:
            shards.append(read_shard(p))
        except (OSError, ValueError) as e:
            torn.append({"path": os.path.basename(p), "error": str(e)})
            _log.warning("skipping torn obs shard %s: %s", p, e)
    return shards, torn


def coverage_report(shards: list[dict],
                    torn: "list[dict] | None" = None) -> dict:
    """The named coverage-gap document the skew/critpath reports carry:
    which process slots the merge actually saw vs the job's declared
    process count (a killed process writes no shard — its absence is
    evidence, and must be NAMED, never silently averaged away)."""
    present = sorted(int(s.get("meta", {}).get("process", 0))
                     for s in shards)
    expected = max([int(s.get("meta", {}).get("n_processes", 0) or 0)
                    for s in shards] + [len(present)])
    missing = sorted(set(range(expected)) - set(present))
    cov = {"expected_processes": expected, "present_processes": present,
           "missing_processes": missing,
           "torn_shards": [t["path"] for t in (torn or [])]}
    if missing or torn:
        cov["note"] = ("post-mortem merge: statistics cover the "
                       "surviving shards only")
    return cov


def find_shards(trace_out: str) -> list[str]:
    """Every ``<trace_out>.proc<i>`` next to the merged-output path,
    ordered by process slot."""
    paths = glob.glob(glob.escape(trace_out) + ".proc*")
    def slot(p):
        try:
            return int(p.rsplit(".proc", 1)[1])
        except ValueError:
            return 1 << 30
    return sorted((p for p in paths if slot(p) < (1 << 30)), key=slot)


def merge_shards(shards: list[dict],
                 allow_clock_skew: bool = False) -> tuple[list[dict], dict]:
    """Combine shard documents into ``(chrome_events, skew_report)``.

    The merged trace maps Chrome ``pid`` to the process slot and keeps
    each shard's compacted ``tid``s; timestamps shift onto a shared axis
    anchored at the earliest shard's wall start.  Mixed-identity shards
    (different config hash / workload) refuse to merge — they are not
    one job.

    Clock alignment is *asserted*, not assumed: each shard must carry a
    usable monotone wall anchor (``wall_start_unix_s`` — the per-process
    offsets it induces are uniform per shard, so intra-process event
    order is preserved by construction), and the aligned lockstep
    barrier rounds must overlap across processes — hosts whose wall
    clocks disagree beyond
    :data:`~map_oxidize_tpu_torch.obs.critpath.CLOCK_SKEW_BOUND_S` refuse with
    a named :class:`~map_oxidize_tpu_torch.obs.critpath.ClockSkewError`
    instead of silently mis-ordering every cross-process edge
    (``allow_clock_skew`` overrides for forensics on known-bad clocks).
    """
    if not shards:
        raise ValueError("no shards to merge")
    metas = [s.get("meta", {}) for s in shards]
    ident = {(m.get("config_hash"), m.get("workload")) for m in metas}
    if len(ident) > 1:
        raise ValueError(
            f"shards disagree on (config_hash, workload): {sorted(ident)} "
            "— they are not shards of one job")
    seen = [m.get("process") for m in metas]
    if len(set(seen)) != len(seen):
        raise ValueError(f"duplicate process slots in shards: {seen}")
    if not allow_clock_skew:
        from map_oxidize_tpu_torch.obs import critpath as _critpath

        # anchor + barrier-overlap check (builds the per-process
        # timelines; merge_to_files already holds them and passes
        # allow_clock_skew=True after checking once itself)
        _critpath.check_clock_alignment(
            _critpath.timelines_from_shards(shards))

    anchor = min(float(m.get("wall_start_unix_s", 0.0)) for m in metas)
    out: list[dict] = []
    for shard, meta in zip(shards, metas):
        p = int(meta.get("process", 0))
        shift_us = (float(meta.get("wall_start_unix_s", 0.0)) - anchor) * 1e6
        out.append({"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                    "args": {"name": f"proc {p}"}})
        for e in shard.get("events", []):
            # each shard carries its own per-process metadata; the
            # process_name/meta rows are replaced by the slot-keyed ones
            if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                        "moxt_meta"):
                continue
            e = dict(e, pid=p)
            if "ts" in e:
                e["ts"] = round(e["ts"] + shift_us, 3)
            out.append(e)
    return out, skew_report(shards)


def skew_report(shards: list[dict]) -> dict:
    """Per-process accounting + straggler ranking from shard documents."""
    procs = []
    for shard in shards:
        meta = shard.get("meta", {})
        m = shard.get("metrics", {})
        counters = m.get("counters", {})
        gauges = m.get("gauges", {})
        work_s = wait_s = 0.0
        by_name: dict[str, float] = {}
        for e in shard.get("events", []):
            if e.get("ph") != "X":
                continue
            dur_s = float(e.get("dur", 0.0)) / 1e6
            name = e.get("name", "")
            if name.startswith(WAIT_SPAN_PREFIXES):
                wait_s += dur_s
                by_name[name] = by_name.get(name, 0.0) + dur_s
            elif name.startswith(WORK_SPAN_PREFIXES):
                work_s += dur_s
                by_name[name] = by_name.get(name, 0.0) + dur_s
        procs.append({
            "process": int(meta.get("process", 0)),
            "records_in": gauges.get("records_in", 0),
            "rows_fed": gauges.get("device_rows_fed",
                                   counters.get("dist/rows_fed", 0)),
            "all_to_all_bytes": counters.get("shuffle/all_to_all_bytes", 0),
            "psum_bytes": counters.get("shuffle/psum_bytes", 0),
            "flag_rounds": gauges.get("flag_rounds", 0),
            "phases_s": m.get("phases_s", {}),
            "work_s": round(work_s, 6),
            "collective_wait_s": round(wait_s, 6),
            "span_s": {k: round(v, 6) for k, v in sorted(by_name.items())},
        })
    procs.sort(key=lambda r: r["process"])

    def spread(key):
        vals = [float(r[key] or 0) for r in procs]
        mean = sum(vals) / len(vals) if vals else 0.0
        return {"min": min(vals, default=0.0), "max": max(vals, default=0.0),
                "mean": round(mean, 6),
                "max_over_mean": round(max(vals) / mean, 4) if mean else None}

    # straggler = most work wall-clock; everyone else's collective wait
    # is (mostly) the bill for its excess
    ranking = sorted(procs, key=lambda r: -r["work_s"])
    return {
        "n_processes": len(procs),
        "processes": procs,
        "records_total": sum(int(r["records_in"] or 0) for r in procs),
        "rows_fed_total": sum(int(r["rows_fed"] or 0) for r in procs),
        "skew": {"records_in": spread("records_in"),
                 "rows_fed": spread("rows_fed"),
                 "work_s": spread("work_s")},
        "straggler_ranking": [
            {"process": r["process"], "work_s": r["work_s"],
             "collective_wait_s": r["collective_wait_s"]}
            for r in ranking],
    }


def merge_to_files(shard_paths: list[str], trace_out: str,
                   skew_out: str | None = None,
                   allow_clock_skew: bool = False) -> dict:
    """Read shards, write the merged Chrome trace to ``trace_out`` and
    the skew report — now carrying the ``coverage`` and ``critpath``
    sections — next to it (``<trace_out>.skew.json`` by default).
    Returns the skew report.

    Tolerant by design: a torn shard (killed process) is skipped with a
    named coverage gap, and the merge proceeds over what survived — the
    post-mortem contract.  Only zero readable shards, mixed identity,
    or wall-clock skew past the alignment bound abort (each with a
    named error)."""
    from map_oxidize_tpu_torch.obs import critpath as _critpath
    from map_oxidize_tpu_torch.obs import write_json_atomic

    shards, torn = read_shards_tolerant(shard_paths)
    if not shards:
        raise ValueError(
            f"no readable obs shards among {len(shard_paths)} path(s)"
            + (f" (torn: {[t['path'] for t in torn]})" if torn else ""))
    # identity/dup-slot refusal first (inside merge_shards), then ONE
    # timeline build shared by the clock check and the critpath
    # extraction — a large trace must not walk its events twice
    events, skew = merge_shards(shards, allow_clock_skew=True)
    timelines = _critpath.timelines_from_shards(shards)
    if not allow_clock_skew:
        _critpath.check_clock_alignment(timelines)
    cov = coverage_report(shards, torn)
    skew["coverage"] = cov
    # the causal layer: critical path, blame, slack, what-if — an
    # inextractable path (no round tags: a pre-critpath trace) is a
    # named note, never a merge failure
    try:
        if len(timelines) == 1:
            cp = _critpath.degenerate_from_attrib(
                timelines[0].attrib, process=timelines[0].process)
            cp["coverage"] = cov
        else:
            cp = _critpath.compute(timelines, coverage=cov)
        skew["critpath"] = cp
    except ValueError as e:
        skew["critpath"] = {"error": str(e)}
    write_json_atomic(trace_out, events, indent=None)
    if skew_out is None:
        skew_out = trace_out + ".skew.json"
    write_json_atomic(skew_out, skew)
    _log.info("merged %d obs shards -> %s (+ %s)", len(shards), trace_out,
              skew_out)
    return skew


def maybe_merge_at_job_end(config, process: int,
                           n_processes: int) -> dict | None:
    """Process 0's end-of-job auto-merge: if every expected shard is
    visible on this filesystem (always true on one host; true on pods
    with shared storage), merge them and return the skew report.
    Missing shards just skip (returns None) — the operator merges by
    hand with ``obs merge`` after copying."""
    if process != 0 or not config.trace_out or config.trace_out == "-":
        return None
    expect = [shard_path(config.trace_out, p) for p in range(n_processes)]
    missing = [p for p in expect if not os.path.isfile(p)]
    if missing:
        _log.info("obs shards not on a shared filesystem (%d of %d "
                  "missing); merge by hand: python -m map_oxidize_tpu_torch obs "
                  "merge %s", len(missing), n_processes, config.trace_out)
        return None
    return merge_to_files(expect, config.trace_out)
