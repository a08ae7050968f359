"""Plan observatory: the predicted-vs-actual side of the job planner.  A
copy of the JAX package's ``obs/plan.py`` (``publish`` :44, ``finalize``
:72, ``render`` :118) in the same ``moxt-plan-v1`` schema.

* :func:`publish` flattens the plan document onto the registry as
  ``plan/*`` gauges at job start: chosen knob values, per-knob
  provenance, the predicted wall and the calibration coverage;
* :func:`finalize` scores the plan at ``Obs.finish``: the measured
  attribution becomes the plan's ``actual`` section and, when the plan
  predicted (``curve`` provenance; a cold run records
  ``platform_default`` instead), ``plan/model_error_pct`` = |predicted -
  actual| / actual wall;
* :func:`render` is the human-readable report.

``finalize`` also scores the exchange-collective decision against the
sampled exchange walls of the comms table, where a sharded engine ran.
"""

from __future__ import annotations

PLAN_SCHEMA = "moxt-plan-v1"

#: ``obs diff --gate``: prediction error growing by more than this many
#: percentage points over the previous comparable run flags (JAX
#: ``obs/plan.py:36``; read by :mod:`~map_oxidize_tpu_torch.obs.ledger`)
PLAN_ERROR_GATE_POINTS = 50.0

#: the provenance taxonomy: per-knob ``curve``/``memo``/``default``/
#: ``pinned``, plus the plan-level ``platform_default`` a cold run records
PROVENANCES = ("curve", "memo", "default", "pinned", "platform_default")


def publish(registry, doc: dict) -> None:
    """Flatten the plan onto the registry at job start: ``plan/mode``,
    ``plan/provenance``, per-knob ``plan/<knob>`` +
    ``plan/<knob>_provenance``, and ``plan/predicted_wall_ms`` when the
    plan predicted."""
    if registry is None or not doc:
        return
    registry.set("plan/mode", doc.get("mode", "auto"))
    registry.set("plan/provenance",
                 doc.get("provenance", "platform_default"))
    for name, row in (doc.get("knobs") or {}).items():
        v = row.get("value")
        if v is not None:
            registry.set(f"plan/{name}", v)
        registry.set(f"plan/{name}_provenance",
                     row.get("provenance", "?"))
    pred = doc.get("predicted")
    if pred and pred.get("wall_ms") is not None:
        registry.set("plan/predicted_wall_ms", pred["wall_ms"])
    # the coverage plane: needs-vs-has over the chooser's consulted
    # cells, on every planned job
    cov = doc.get("coverage")
    if cov:
        registry.set("calib/coverage_pct", cov.get("coverage_pct"))
        registry.set("calib/extrapolation_bucket_distance",
                     cov.get("extrapolation_bucket_distance"))


def finalize(obs, doc: dict, attrib_doc: dict | None) -> dict:
    """Score the plan against the measured run (``Obs.finish``, after
    the attribution finalize): attach the ``actual`` section and, when
    the plan predicted, set ``plan/model_error_pct``.  Mutates and
    returns ``doc``."""
    if not attrib_doc:
        return doc
    actual = {
        "wall_ms": attrib_doc.get("wall_ms"),
        "buckets": {name: row.get("ms")
                    for name, row
                    in (attrib_doc.get("buckets") or {}).items()},
        "unattributed_ms": attrib_doc.get("unattributed_ms"),
    }
    doc["actual"] = actual
    pred = doc.get("predicted")
    wall = actual.get("wall_ms")
    if pred and pred.get("wall_ms") and wall:
        err = (100.0 * abs(float(pred["wall_ms"]) - float(wall))
               / max(float(wall), 1e-9))
        doc["model_error_pct"] = round(err, 2)
        obs.registry.set("plan/model_error_pct", doc["model_error_pct"])
        obs.registry.set("plan/actual_wall_ms", wall)
    # score the exchange-collective decision: the chooser predicted a
    # per-exchange latency from the store curve; the run measured the
    # real one (the sampled collective walls of the comms table)
    ex = doc.get("exchange")
    if ex and ex.get("method"):
        rows = [r for r in obs.registry.comms_table()
                if r.get("collective") == ex["method"]
                and r.get("latency_ms")]
        if rows:
            best = max(rows, key=lambda r: r["latency_ms"]["count"])
            ex["actual_ms_per_exchange"] = round(
                best["latency_ms"]["mean"], 4)
            ev = (ex.get("evidence") or {}).get(ex["method"])
            if isinstance(ev, dict) and ev.get("predicted_ms") is not None:
                ex["predicted_ms_per_exchange"] = ev["predicted_ms"]
    return doc


# --- rendering -------------------------------------------------------------


def render(doc: dict, title: str = "plan vs actual") -> str:
    """Human-readable plan report: the knob table (value + provenance +
    one-line evidence) and, when the plan predicted, the predicted-vs-
    actual wall per attribution bucket.  Pure, so tests pin it."""
    mode = doc.get("mode", "auto")
    prov = doc.get("provenance", "platform_default")
    head = f"{title}: {doc.get('workload', '?')} (--plan {mode}, {prov}"
    if doc.get("model_error_pct") is not None:
        head += f", model error {doc['model_error_pct']:.1f}%"
    lines = [head + ")"]
    knobs = doc.get("knobs") or {}
    if knobs:
        width = max(len(n) for n in knobs)
        for name, row in knobs.items():
            ev = row.get("evidence") or {}
            evs = " ".join(f"{k}={v}" for k, v in ev.items())
            lines.append(
                f"  {name:<{width}} = {row.get('value')!s:<10} "
                f"[{row.get('provenance', '?'):<7}] {evs}".rstrip())
    ex = doc.get("exchange")
    if ex and ex.get("method"):
        line = (f"exchange collective: {ex['method']} "
                f"[{ex.get('provenance', '?')}] @ {ex.get('bucket')} — "
                f"{ex.get('reason', '')}")
        if ex.get("actual_ms_per_exchange") is not None:
            line += f"; measured {ex['actual_ms_per_exchange']}ms/exchange"
            if ex.get("predicted_ms_per_exchange") is not None:
                line += (f" (predicted "
                         f"{ex['predicted_ms_per_exchange']}ms)")
        lines.append(line)
    cov = doc.get("coverage")
    if cov and cov.get("needed"):
        lines.append(
            f"calibration coverage: {cov['covered']}/{cov['needed']} "
            f"cells ({cov['coverage_pct']}%), worst extrapolation "
            f"{cov['extrapolation_bucket_distance']} bucket(s)")
    pred = doc.get("predicted")
    actual = doc.get("actual")
    if pred and pred.get("buckets"):
        lines.append(
            f"predicted wall {pred.get('wall_ms', 0.0) / 1e3:.3f}s "
            f"(curve of {pred.get('curve_runs', '?')} runs)"
            + (f" vs actual {actual['wall_ms'] / 1e3:.3f}s"
               if actual and actual.get("wall_ms") else ""))
        abuckets = (actual or {}).get("buckets") or {}
        names = list(pred["buckets"])
        width = max(len(n) for n in names)
        for name in names:
            p = float(pred["buckets"].get(name) or 0.0)
            a = abuckets.get(name)
            line = f"  {name:<{width}} {p / 1e3:>9.3f}s predicted"
            if a is not None:
                line += f" {float(a) / 1e3:>9.3f}s actual"
                if p > 0 or a:
                    delta = float(a) - p
                    line += f" {delta / 1e3:>+9.3f}s"
            lines.append(line)
    elif actual and actual.get("wall_ms"):
        lines.append(f"no prediction ({prov}); actual wall "
                     f"{actual['wall_ms'] / 1e3:.3f}s")
    return "\n".join(lines)
