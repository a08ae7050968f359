"""Cross-run regression forensics: trajectories, step changes, movers.  A
copy of the JAX package's ``obs/trend.py`` (``trajectories`` :59,
``detect_steps`` :107, ``movers`` :136, ``analyze`` :173, ``bench_rounds``
:189, ``archive_entries`` :237, ``render`` :282): the same analysis and the
same text, so ``obs trend`` prints the same bytes from either package.

The run ledger appends one entry per finished job and ``obs diff``
compares exactly two of them.  When a gate trips, the question is "which
counter moved, and when".  This module reads the whole history:

* :func:`trajectories` — every phase wall-clock and numeric metric as an
  aligned value list across N entries (oldest first);
* :func:`detect_steps` — per-series step-change detection: an entry
  whose value jumps beyond a threshold against the median of everything
  before it (medians, not means: one outlier round must not mask or
  fake a step);
* :func:`movers` — the forensics report for a gate failure: the LAST
  entry against the median of the prior ones, every changed series
  ranked by relative movement, regression direction annotated from the
  series' semantics (time/latency up = bad, rate/MFU down = bad);
* :func:`bench_rounds` — adapts ``BENCH_r*.json`` and ``MULTICHIP_r*.json``
  artifacts into the same entry shape;
* :func:`archive_entries` — the same for a fleet series archive
  (:class:`map_oxidize_tpu_torch.obs.fleet.SeriesArchive`).

Pure host-side data work — no torch, no device; the ``obs trend`` CLI
(:mod:`map_oxidize_tpu_torch.obs.cli`) owns the I/O.
"""

from __future__ import annotations

import json

#: movers/steps ignore sub-noise movement below this relative change
MIN_MOVE_PCT = 1.0

#: metrics excluded from movers/steps: identity/bookkeeping, not signals
_SKIP = ("ts_unix_s", "aborted")


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _flat_metrics(entry: dict) -> dict:
    """One ledger entry's numeric series: ``phase/<p>_s`` from the lifted
    phase map plus every numeric key of the stored metrics summary
    (minus the duplicate ``time/`` spellings)."""
    out = {}
    for k, v in (entry.get("phases_s") or {}).items():
        if _numeric(v):
            out[f"phase/{k}_s"] = v
    for k, v in (entry.get("metrics") or {}).items():
        if k.startswith("time/") or k in _SKIP:
            continue
        if _numeric(v):
            out[k] = v
    return out


def trajectories(entries: list[dict]) -> dict[str, list]:
    """Aligned per-series value lists across the entries, oldest first
    (``None`` where an entry lacks the series)."""
    flats = [_flat_metrics(e) for e in entries]
    names: dict[str, None] = {}
    for f in flats:
        for k in f:
            names.setdefault(k)
    return {name: [f.get(name) for f in flats] for name in names}


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def _pct(base: float, after: float) -> float | None:
    if base == 0:
        return None
    return 100.0 * (after - base) / abs(base)


def _direction(name: str, pct: float | None) -> str:
    """Regression-direction annotation from the series' semantics:
    durations/latencies/compile counts/stalls regress UP, throughput and
    utilization regress DOWN, everything else just 'moved'."""
    if pct is None:
        return "new"
    up_bad = (name.startswith(("phase/", "compile/", "alerts/"))
              or name.endswith(("_s", "_ms", "/p50", "/p95", "/max"))
              # model-fidelity gauges (plan/model_error_pct, critpath/
              # model_error_pct): prediction error growing is the
              # planner's or replayer's model going stale
              or name.endswith("model_error_pct")
              or "stall" in name or "spill" in name
              or name in ("rc", "unattributed_pct",
                          "attrib/unattributed_pct"))
    down_bad = (name in ("rate", "records_per_sec", "ok")
                or name.endswith(("/mfu_pct", "_per_sec", "overlap_ratio",
                                  "vs_baseline")))
    if up_bad:
        return "regressed" if pct > 0 else "improved"
    if down_bad:
        return "regressed" if pct < 0 else "improved"
    return "moved"


def detect_steps(traj: dict[str, list], threshold_pct: float = 25.0,
                 min_points: int = 3) -> list[dict]:
    """Per-series step changes: for every position i >= 2, compare the
    value against the median of everything before it; the series' LARGEST
    such jump beyond ``threshold_pct`` is reported.  Needs at least
    ``min_points`` numeric points."""
    steps = []
    for name, vals in traj.items():
        pts = [(i, v) for i, v in enumerate(vals) if _numeric(v)]
        if len(pts) < min_points:
            continue
        best = None
        for j in range(2, len(pts)):
            prior = [v for _i, v in pts[:j]]
            base = _median(prior)
            i, v = pts[j]
            pct = _pct(base, v)
            if pct is None or abs(pct) < max(threshold_pct, MIN_MOVE_PCT):
                continue
            if best is None or abs(pct) > abs(best["pct"]):
                best = {"name": name, "index": i, "before": base,
                        "after": v, "pct": round(pct, 1)}
        if best is not None:
            best["direction"] = _direction(name, best["pct"])
            steps.append(best)
    steps.sort(key=lambda s: -abs(s["pct"]))
    return steps


def movers(entries: list[dict], top: int = 0,
           min_pct: float = MIN_MOVE_PCT) -> list[dict]:
    """The gate-failure attribution report: the LAST entry against the
    median of all prior entries, ranked by relative movement (series
    appearing from nothing rank first — a brand-new counter in a gated
    run is the loudest possible signal).  ``top`` bounds the list
    (0 = all movers)."""
    if len(entries) < 2:
        return []
    traj = trajectories(entries)
    rows = []
    for name, vals in traj.items():
        last = vals[-1]
        prior = [v for v in vals[:-1] if _numeric(v)]
        if not _numeric(last) or not prior:
            continue
        base = _median(prior)
        if last == base:
            continue
        pct = _pct(base, last)
        if pct is not None and abs(pct) < min_pct:
            continue
        rows.append({
            "name": name,
            "before": base,
            "after": last,
            "pct": None if pct is None else round(pct, 1),
            "direction": _direction(name, pct),
        })
    # new-from-zero first, then by |pct|
    rows.sort(key=lambda r: (0 if r["pct"] is None else 1,
                             -abs(r["pct"] or 0)))
    for rank, r in enumerate(rows, 1):
        r["rank"] = rank
    return rows[:top] if top else rows


def analyze(entries: list[dict], threshold_pct: float = 25.0,
            top: int = 10) -> dict:
    """The full trend document one entry group (same workload) feeds the
    CLI: trajectories, steps, and the movers ranking."""
    traj = trajectories(entries)
    return {
        "n_entries": len(entries),
        "workload": entries[-1].get("workload") if entries else None,
        "config_hash": entries[-1].get("config_hash") if entries else None,
        "labels": [e.get("label") or _ts_label(e) for e in entries],
        "trajectories": traj,
        "steps": detect_steps(traj, threshold_pct),
        "movers": movers(entries, top=top),
    }


def bench_rounds(paths: list[str]) -> list[dict]:
    """Adapt round artifacts into ledger-shaped entries (sorted by
    filename = round order).  Two shapes load:

    * ``BENCH_r*.json`` — the parsed headline value plus every
      per-workload scoreboard ratio (workload ``bench-rounds``);
    * ``MULTICHIP_r*.json`` — the multichip dryrun smoke record
      (``n_devices``/``rc``/``ok``/``skipped``, workload
      ``multichip-rounds``), so multichip trajectories get the same
      movers report: an ``ok`` flipping 1 -> 0, or ``rc`` appearing
      from nothing, ranks first.

    Mixed path lists are fine — the CLI groups entries by workload, so
    the two families trend separately, never against each other."""
    entries = []
    for path in sorted(paths):
        with open(path) as f:
            doc = json.load(f)
        parsed = doc.get("parsed", doc)  # raw BENCH_DETAIL works too
        if not isinstance(parsed, dict):
            # a round whose run printed no result (``"parsed": null``,
            # as in BENCH_r01/r03): a point with no values, where the
            # JAX package raises AttributeError
            parsed = {}
        metrics: dict = {}
        workload = "bench-rounds"
        if "n_devices" in doc and "workloads" not in parsed:
            # the multichip smoke record: no scoreboard, but pass/fail
            # and the device count ARE the trajectory
            workload = "multichip-rounds"
            for key in ("n_devices", "rc"):
                if _numeric(doc.get(key)):
                    metrics[key] = doc[key]
            for key in ("ok", "skipped"):
                if isinstance(doc.get(key), bool):
                    metrics[key] = int(doc[key])
        else:
            if _numeric(parsed.get("value")):
                metrics["headline"] = parsed["value"]
            if _numeric(parsed.get("vs_baseline")):
                metrics["vs_baseline"] = parsed["vs_baseline"]
            for name, ratio in (parsed.get("workloads") or {}).items():
                if _numeric(ratio):
                    metrics[f"workloads/{name}/vs_baseline"] = ratio
        entries.append({
            "workload": workload,
            "label": path.rsplit("/", 1)[-1],
            "phases_s": {},
            "metrics": metrics,
        })
    return entries


def archive_entries(root: str, last: int = 0) -> list[dict]:
    """Adapt a fleet series archive (``--archive-dir``,
    ``moxt-archive-v1`` — :class:`map_oxidize_tpu_torch.obs.fleet.
    SeriesArchive`) into ledger-shaped entries, one per archived sample,
    so the whole analysis path (trajectories, steps, movers) reads fleet
    history that OUTLIVES every producer process — the post-mortem no
    longer depends on the process that died having flushed its metrics
    document.  ``last`` keeps only the newest N samples (0 = all)."""
    from map_oxidize_tpu_torch.obs.fleet import SeriesArchive

    samples = SeriesArchive.samples(root)
    if last and last > 1:
        samples = samples[-last:]
    entries = []
    for ts, values in samples:
        entries.append({
            "workload": "fleet-archive",
            "ts_unix_s": ts,
            "phases_s": {},
            "metrics": {k: v for k, v in values.items()
                        if _numeric(v)},
        })
    return entries


def _ts_label(entry: dict) -> str:
    import time as _time

    ts = entry.get("ts_unix_s")
    if not _numeric(ts):
        return "?"
    return _time.strftime("%m-%dT%H:%M", _time.localtime(ts))


# --- rendering --------------------------------------------------------------


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.4g}"
    return f"{v:,}"


def render(analysis: dict, show_series: int = 0) -> str:
    """The ``obs trend`` stdout: a trajectory table (phases + stepped +
    top-moving series; every series with ``show_series``), the detected
    steps, and the ranked movers report."""
    labels = analysis["labels"]
    traj = analysis["trajectories"]
    steps = analysis["steps"]
    mv = analysis["movers"]
    out = [f"trend: {analysis.get('workload') or '?'} — "
           f"{analysis['n_entries']} entries "
           f"({labels[0]} .. {labels[-1]})"]

    interesting = [n for n in traj if n.startswith("phase/")]
    interesting += [s["name"] for s in steps]
    interesting += [r["name"] for r in mv[:10]]
    if show_series:
        interesting = list(traj)
    seen: set[str] = set()
    names = [n for n in interesting
             if n in traj and not (n in seen or seen.add(n))]
    if names:
        width = max(len(n) for n in names)
        ncol = min(len(labels), 8)
        out.append(f"  {'series':<{width}}  " + "  ".join(
            f"{lbl[-10:]:>10}" for lbl in labels[-ncol:]))
        for n in names:
            vals = traj[n][-ncol:]
            out.append(f"  {n:<{width}}  "
                       + "  ".join(f"{_fmt(v):>10}" for v in vals))
    if steps:
        out.append("step changes (vs median of prior entries):")
        for s in steps[:10]:
            out.append(
                f"  {s['name']} @ entry {s['index'] + 1}: "
                f"{_fmt(s['before'])} -> {_fmt(s['after'])} "
                f"({s['pct']:+.1f}%, {s['direction']})")
    else:
        out.append("no step changes beyond threshold")
    if mv:
        out.append("movers — last entry vs median of prior "
                   "(gate-failure attribution, worst first):")
        for r in mv:
            pct = "NEW" if r["pct"] is None else f"{r['pct']:+.1f}%"
            out.append(f"  {r['rank']:>2}. {r['name']}: "
                       f"{_fmt(r['before'])} -> {_fmt(r['after'])}  "
                       f"{pct}  [{r['direction']}]")
    else:
        out.append("no movers: last entry matches the history")
    return "\n".join(out)
