"""Wall-clock attribution ledger: where did every millisecond go.  The port
of the JAX package's ``obs/attrib.py`` (``compute`` :125, ``where_token``
:202, ``publish`` :212, ``live_update`` :227, ``finalize`` :236,
``render`` :250).

The decomposition sums to the job's wall: every bucket is critical-path
time measured on the job's consumer side, so buckets are disjoint by
construction, and the gap between their sum and the measured wall is
reported as the ``unattributed`` remainder, never hidden.  ``Obs.finish``
(and the flight recorder) publishes it as the flat ``attrib/*_ms`` /
``attrib/unattributed_pct`` gauges and the metrics document's ``attrib``
section.

Bucket definitions (ms on the job's critical path), with the sources the
port feeds:

``setup``
    ``Obs`` creation to the first phase span (``attrib/pre_phase_ms``,
    stamped by the first ``Obs.phase``) plus device bring-up measured
    inside a phase (``attrib/init_ms``: the device resolve, the staging
    ring and the first copies of a streamed fit).
``host_produce``
    Host production on the critical path: the ``split`` phase plus
    explicitly measured inline produce (``attrib/probe_ms``: the dispatch
    resolver's produce probe).  In a
    pipelined run the steady-state produce is hidden in the prefetch
    thread; its visible residue is ``feed_wait``.
``feed_wait``
    Consumer stalls waiting on the prefetch/staging pipeline
    (``pipeline/feed_wait_ms``, fed live per chunk).
``host_stage``
    Host work inside the per-block engine feed that is not dispatch,
    compile, sampled compute or spill I/O: padding, packing and the
    host-to-device copy (``feed_block_ms`` total minus those, clamped at
    zero).
``dispatch_gap``
    Call-to-return walls of every non-compiling dispatch of an observed
    program (``device/dispatch_gap_ms``, from the launch ledger,
    :mod:`~map_oxidize_tpu_torch.obs.compile`).
``device_compute``
    The device waits the job pays (``device/compute_ms``): the blocking
    fetches and the ledger's sampled device waits.
``collective_wait``
    Lockstep waits on the slowest participant (``dist/flag_wait_ms``); 0
    on one device.
``spill_io``
    Disk-bucket shuffle spill writes and drains (``spill/io_ms``).
``host_sort``
    Host-side dataflow finalize compute (``attrib/host_sort_ms``).
``compile``
    Compiling dispatches (first calls under a new signature, a kernel
    build included), from the ledger's per-program rows (``programs``),
    plus ``attrib/lowering_ms`` (the ledger's cost reckoning of new
    signatures).
``host_write``
    The host-only ``write`` output phase.
"""

from __future__ import annotations

import time

ATTRIB_SCHEMA = "moxt-attrib-v1"

#: bucket order for reports (stable, most-upstream first)
BUCKETS = ("setup", "host_produce", "feed_wait", "host_stage",
           "dispatch_gap", "device_compute", "collective_wait",
           "spill_io", "host_sort", "compile", "host_write")

#: short spellings for the heartbeat's one-token ``where=`` field
SHORT = {
    "setup": "setup", "host_produce": "produce", "feed_wait": "wait",
    "host_stage": "stage", "dispatch_gap": "dispatch",
    "device_compute": "compute", "collective_wait": "comms",
    "spill_io": "spill", "host_sort": "sort", "compile": "compile",
    "host_write": "write", "unattributed": "other",
}

#: ``obs diff --gate``: an unattributed fraction growing by more than
#: this many percentage points over the previous comparable run flags
#: (JAX ``obs/attrib.py:100``)
UNATTRIBUTED_GATE_POINTS = 10.0

#: host-only phases attributed wholesale (``replay`` and ``finalize`` run
#: device work, so they contribute through the metric-derived buckets)
_PRODUCE_PHASES = ("split", "sample")
_WRITE_PHASES = ("write",)


def _hist_total_ms(registry, name: str) -> float:
    h = registry.histograms.get(name)
    return float(h.total) if h is not None else 0.0


def compute(obs, programs: dict | None = None,
            elapsed_s: float | None = None) -> dict:
    """The attribution document: wall, per-bucket ms + pct, remainder.

    ``programs`` is the per-program compile/dispatch row map: the job's
    live launch-ledger overlay when None (the live plane's reads), the
    closed window's report rows at finish.  ``elapsed_s`` overrides the
    wall (default: now - the tracer's wall start)."""
    if programs is None:
        from map_oxidize_tpu_torch.obs.compile import job_overlay_delta

        programs = job_overlay_delta(obs)
    if elapsed_s is None:
        elapsed_s = max(time.time() - obs.tracer.wall_start, 1e-9)
    wall_ms = elapsed_s * 1e3

    reg = obs.registry
    with reg._lock:
        counters = dict(reg.counters)
        gauges = dict(reg.gauges)
        phases = dict(reg.phases)
        gap_ms = _hist_total_ms(reg, "device/dispatch_gap_ms")
        compute_ms = _hist_total_ms(reg, "device/compute_ms")
        flag_wait_ms = _hist_total_ms(reg, "dist/flag_wait_ms")
        feed_block_ms = _hist_total_ms(reg, "feed_block_ms")

    compile_ms = (sum(r.get("compile_ms", 0.0) or 0.0
                      for r in programs.values())
                  + float(counters.get("attrib/lowering_ms", 0.0)))
    flag_gap_ms = (programs.get("dist/flag_psum") or {}).get(
        "dispatch_ms", 0.0) or 0.0
    spill_io = float(counters.get("spill/io_ms", 0.0))
    feed_wait = float(counters.get("pipeline/feed_wait_ms", 0.0))

    buckets = {
        # the sources live under their own names; the published
        # attrib/setup_ms gauge is this bucket's output and must never
        # feed back in
        "setup": (float(gauges.get("attrib/pre_phase_ms", 0.0))
                  + float(counters.get("attrib/init_ms", 0.0))),
        "host_produce": (
            float(counters.get("attrib/probe_ms", 0.0))
            + sum(phases.get(p, 0.0) for p in _PRODUCE_PHASES) * 1e3),
        "feed_wait": feed_wait,
        "host_stage": max(
            0.0, feed_block_ms - gap_ms - compute_ms - spill_io
            - compile_ms),
        "dispatch_gap": max(0.0, gap_ms - flag_gap_ms),
        "device_compute": compute_ms,
        "collective_wait": flag_wait_ms,
        "spill_io": spill_io,
        "host_sort": float(counters.get("attrib/host_sort_ms", 0.0)),
        "compile": compile_ms,
        "host_write": sum(phases.get(p, 0.0)
                          for p in _WRITE_PHASES) * 1e3,
    }
    attributed = sum(buckets.values())
    unattributed = max(0.0, wall_ms - attributed)
    return {
        "schema": ATTRIB_SCHEMA,
        "wall_ms": round(wall_ms, 3),
        "attributed_ms": round(attributed, 3),
        "unattributed_ms": round(unattributed, 3),
        "unattributed_pct": round(100.0 * unattributed
                                  / max(wall_ms, 1e-9), 2),
        "buckets": {
            name: {"ms": round(ms, 3),
                   "pct": round(100.0 * ms / max(wall_ms, 1e-9), 2)}
            for name, ms in buckets.items()},
    }


def where_token(doc: dict) -> str:
    """The heartbeat's one-token answer, e.g. ``compute 61%``: the largest
    bucket (the unattributed remainder competes as ``other``)."""
    best_name, best_pct = "unattributed", doc["unattributed_pct"]
    for name, row in doc["buckets"].items():
        if row["pct"] > best_pct:
            best_name, best_pct = name, row["pct"]
    return f"{SHORT.get(best_name, best_name)} {best_pct:.0f}%"


def publish(obs, doc: dict) -> None:
    """Flatten the document onto the registry as ``attrib/*`` gauges and
    refresh the heartbeat's ``where=`` token."""
    reg = obs.registry
    for name, row in doc["buckets"].items():
        reg.set(f"attrib/{name}_ms", row["ms"])
    reg.set("attrib/wall_ms", doc["wall_ms"])
    reg.set("attrib/unattributed_ms", doc["unattributed_ms"])
    reg.set("attrib/unattributed_pct", doc["unattributed_pct"])
    hb = obs.heartbeat
    if hb is not None:
        hb.where = where_token(doc)


def live_update(obs) -> dict:
    """One live refresh (each time-series tick calls this, JAX
    ``obs/attrib.py:227``): compute from the running overlay, publish the
    gauges and the heartbeat token, return the document (the ``/status``
    payload's ``attrib`` section)."""
    doc = compute(obs)
    publish(obs, doc)
    return doc


def finalize(obs, xprof_report: dict | None, elapsed_s: float) -> dict:
    """The end-of-job attribution (``Obs.finish`` and the flight
    recorder), from the closed launch-ledger window's per-program rows:
    computed, published and returned for the metrics document."""
    programs = (xprof_report or {}).get("programs") or {}
    doc = compute(obs, programs=programs, elapsed_s=elapsed_s)
    publish(obs, doc)
    return doc


def render(doc: dict, title: str = "where did the time go") -> str:
    """Human-readable bucket table, largest first."""
    wall_s = doc.get("wall_ms", 0.0) / 1e3
    lines = [f"{title}: wall {wall_s:.3f}s, "
             f"{100.0 - doc.get('unattributed_pct', 0.0):.1f}% attributed"]
    rows = [(name, row["ms"], row["pct"])
            for name, row in (doc.get("buckets") or {}).items()]
    rows.append(("unattributed", doc.get("unattributed_ms", 0.0),
                 doc.get("unattributed_pct", 0.0)))
    width = max(len(n) for n, _m, _p in rows)
    for name, ms, pct in sorted(rows, key=lambda r: -r[1]):
        bar = "#" * min(int(round(pct / 2.5)), 40)
        lines.append(f"  {name:<{width}} {ms / 1e3:>9.3f}s {pct:>5.1f}%  "
                     f"{bar}")
    return "\n".join(lines)
