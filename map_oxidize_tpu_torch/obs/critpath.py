"""Critical path of a one-process job.  The port of the single-process
half of the JAX package's ``obs/critpath.py`` (``degenerate_from_attrib``
:661, ``headline`` :715, ``publish`` :770, ``render`` :783, and
``_whatif_row`` :607), in the same ``moxt-critpath-v1`` document.

A single-process job has no cross-process happens-before DAG: its path
degenerates to the attribution timeline, one segment per attribution
bucket, 100% blame on the one process, no slack, and the feed-wait bucket
as the overlap what-if (the host produce the pipeline did not hide).
``Obs.finish`` publishes the headline ``critpath/*`` gauges and the
metrics document's ``critpath`` section.  The multi-process path (shard
timelines, barrier rounds, the replay what-ifs) comes with the sharded
engines (ROADMAP A8).
"""

from __future__ import annotations

CRITPATH_SCHEMA = "moxt-critpath-v1"

#: the what-if name the single-process document carries
WHATIF_OVERLAP = "map_shuffle_overlapped"


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
    """The flat ``critpath/*`` gauges a job's metrics carry.  One process
    takes all the blame, so the bound fraction is the dominant cost's
    share of the wall (the largest bucket, which ``bound_by`` names)."""
    slack = doc.get("slack") or {}
    top_slack = max((row.get("slack_ms", 0.0) for row in slack.values()),
                    default=0.0)
    wall = float(doc.get("wall_ms") or 0.0)
    top_ms = max((s.get("ms", 0.0) for s in doc.get("segments") or []),
                 default=0.0)
    return {
        "critpath/bound_frac": round(top_ms / wall if wall else 0.0, 4),
        "critpath/top_process_slack_ms": round(top_slack, 3),
        "critpath/collective_wait_share_pct":
            (doc.get("collective_wait") or {}).get("share_pct", 0.0),
        "critpath/path_over_wall_pct": doc.get("path_over_wall_pct", 0.0),
        "critpath/bound_by": doc.get("bound_by", "?"),
    }


def publish(registry, doc: dict) -> dict:
    """Set the headline gauges on a job registry; returns the gauge
    map."""
    gauges = headline(doc)
    for k, v in gauges.items():
        registry.set(k, v)
    return gauges


# --- rendering -------------------------------------------------------------


def render(doc: dict, title: str = "critical path") -> str:
    """Human-readable report of a one-process document: the JAX package's
    ``render`` less the cross-process parts (coverage gaps, slack, round
    segments) such a document never has.  Pure, so tests pin it."""
    wall_s = doc.get("wall_ms", 0.0) / 1e3
    lines = [f"{title}: wall {wall_s:.3f}s, path covers "
             f"{doc.get('path_over_wall_pct', 0.0):.1f}% "
             f"({doc.get('n_processes', 1)} process(es), "
             f"{doc.get('rounds', 0)} lockstep rounds)"]
    lines.append(f"bound by: {doc.get('bound_by', '?')}")
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
    what_if = doc.get("what_if") or []
    if what_if:
        lines.append("what-if (deterministic replay of the round model):")
        for w in what_if[:6]:
            lines.append(
                f"  {w['name']:<34} wall -{w['est_delta_pct']:>5.1f}% "
                f"(-{w['est_delta_ms'] / 1e3:.3f}s) — {w['description']}")
    lines.append("(single process: path degenerates to the attribution "
                 "timeline)")
    for s in (doc.get("segments") or [])[:12]:
        name = next(iter(s.get("buckets") or {"work": 0}))
        lines.append(f"  {s['ms'] / 1e3:>8.3f}s  {name}")
    return "\n".join(lines)
