"""Job planner: solve the tunable knobs from measured curves before the
run, and say where every number came from.  The port of the JAX package's
``runtime/planner.py`` (``solve_batch`` :86, ``estimate_shape`` :111,
``_pinned_knobs`` :136, ``build_plan`` :146) with the same knob rows,
provenance and ``moxt-plan-v1`` document, plus its copy of the collective
chooser the plan's ``exchange_collective`` row records (JAX
``parallel/shuffle.py``: ``exchange_payload_bytes`` :55,
``choose_collective`` :68).

The plan has one row per knob (dispatch batch B, pipeline depth, chunk
size, shuffle transport, sort sample, exchange collective): the chosen
value, its provenance and its evidence.  Provenance:

* ``pinned``: the user set a non-default value; the planner records it;
* ``curve``: solved or confirmed from the calibration store's measured
  rows for this (platform, device-count, topology) identity;
* ``memo``: this process already resolved the knob (dispatch's memo);
* ``default``: no measurement exists; the default is recorded as a
  default, never dressed up as a prediction.

A cold run carries overall provenance ``platform_default`` and no
predicted wall; a warm run predicts the wall from the store's workload
curve, in the attribution's bucket names, and ``obs/plan.py`` scores it
at finish.  The planner never mutates the config: solved values apply
through ``Obs.knob()`` (pipeline depth, shuffle transport) and through
the dispatch resolver's own reading of the same curve (B).  The
``exchange_collective`` decision applies to the sharded engines
(``num_shards > 1``; ``runtime/driver.py`` ``solved_exchange``).
"""

from __future__ import annotations

import dataclasses
import math
import os

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: every knob a plan documents, in render order
PLAN_KNOBS = ("dispatch_batch", "pipeline_depth", "chunk_bytes",
              "shuffle_transport", "sort_sample", "exchange_collective")

#: workloads whose mesh path routes through the pair-collect engines
#: (fully-safe bucket cap, 8-byte doc planes); everything else that
#: exchanges uses the fold engine's derived cap and 4-byte values
_COLLECT_WORKLOADS = ("invertedindex", "sort", "join", "sessionize")

#: which observed program each workload's batched streamed dispatch runs:
#: auto-B is solved per program, and only the streamed k-means path has
#: one (the fold engine batches only under an explicit pin)
_BATCH_PROGRAM = {"kmeans": "kmeans/stream_step"}

#: record-model workloads: fixed 16-byte (u64, u64) rows — everything
#: else is text at the shuffle router's conservative bytes/row estimate
_RECORD_WORKLOADS = ("sort", "join", "sessionize")

#: feed-wait share of wall (percent) above which the measured curve
#: says the prefetch pipeline is too shallow — the device feed is
#: visibly starving — and one more unit of depth is worth one more
#: chunk of host RAM
FEED_WAIT_DEEPEN_PCT = 15.0
#: curve-driven depth ceiling: past ~4 chunks of readahead the producer
#: threads are already saturated and extra depth only buys memory
MAX_PLANNED_DEPTH = 4
#: exchange share of wall (percent) above which the measured curve says
#: the shuffle barrier is worth hiding behind map — the plan then routes
#: the shuffle_transport knob to 'pipelined' (resident routes only; a
#: spill route means rows exceed the cap and placement, not cadence, is
#: the bottleneck)
EXCHANGE_PUSH_PCT = 10.0


def solve_batch(floor_ms: float, compute_ms: float | None = None,
                produce_ms: float | None = None, default_auto: int = 4,
                max_b: int = 64) -> tuple[int, str]:
    """The auto-B overlap roofline, shared by the dispatch resolver and
    the planner's pre-solve: steady-state wall per chunk under double
    buffering is ``max(produce, floor / B + compute)``, so pick the
    smallest B that sinks the device side under the host side — or,
    when the host is not the bottleneck (or produce is unknown),
    amortize the floor against compute alone.  Returns ``(B, rule)``.
    """
    if compute_ms is None and produce_ms is None:
        return max(1, min(default_auto, max_b)), "default_no_measurements"
    comp = compute_ms or 0.0
    headroom = (produce_ms - comp) if produce_ms is not None else None
    if headroom is not None and headroom > 0.05:
        # host-bound once overlapped: the smallest B whose launch
        # floor sinks under the produce time
        b = math.ceil(floor_ms / headroom)
        rule = "overlap_host_produce"
    else:
        b = math.ceil(floor_ms / max(comp, 0.05))
        rule = "amortize_vs_compute"
    return max(1, min(b, max_b)), rule


def estimate_shape(config, workload: str) -> dict:
    """The workload's estimated shape — the planner's only job-side
    inputs: corpus bytes (stat, 0 when unreadable), estimated rows
    (the shuffle router's bytes/row model: 16 for fixed-width record
    workloads, the same conservative 16 for text), and the chunk
    count the chunker will derive."""
    corpus = 0
    try:
        corpus = os.path.getsize(config.input_path)
    except (OSError, TypeError):
        pass
    from map_oxidize_tpu_torch.shuffle.base import AUTO_BYTES_PER_ROW

    chunk = max(int(getattr(config, "chunk_bytes", 0) or 0), 1)
    n_chunks = int(getattr(config, "num_chunks", 0) or 0)
    if n_chunks <= 0 and corpus:
        n_chunks = max(1, math.ceil(corpus / chunk))
    return {
        "corpus_bytes": corpus,
        "est_rows": corpus // AUTO_BYTES_PER_ROW if corpus else 0,
        "n_chunks": n_chunks,
        "record_model": workload in _RECORD_WORKLOADS,
    }


def _pinned_knobs(config) -> set:
    """Knobs the user overrode: any plan knob whose config value differs
    from the dataclass default.  Derived from the config object itself
    (not CLI parsing), so server submissions with JSON overrides and
    one-shot CLI runs record pins identically."""
    defaults = {f.name: f.default for f in dataclasses.fields(type(config))}
    return {k for k in PLAN_KNOBS
            if getattr(config, k, None) != defaults.get(k)}


def exchange_payload_bytes(num_shards: int, bucket_cap: int,
                           value_row_bytes: int) -> int:
    """Bytes one full exchange moves: every shard sends a ``[S, cap]``
    buffer of (hi, lo, value) rows, ``S * S * cap`` rows of ``8 +
    value_row_bytes`` bytes in all."""
    return num_shards * num_shards * bucket_cap * (8 + value_row_bytes)


def choose_collective(store, ident: dict, num_shards: int,
                      bucket_cap: int, value_row_bytes: int = 8,
                      min_samples: int | None = None,
                      requested: str = "auto") -> dict:
    """The store-driven exchange-collective decision: price one exchange
    at this job's payload bucket under both collectives' measured curves
    and pick the cheaper, but only on exact-bucket evidence with at least
    ``min_samples`` sampled latencies for both; anything less keeps the
    default (``all_to_all``) with a named reason.  ``requested != 'auto'``
    is a pin.  Returns ``{method, provenance, reason, bucket,
    payload_bytes, evidence}``."""
    from map_oxidize_tpu_torch.obs.calib import (
        CALIB_MIN_SAMPLES,
        EXCHANGE_COLLECTIVE_NAMES,
        collective_evidence,
        interpolate_latency_ms,
        shape_bucket,
    )

    if min_samples is None:
        min_samples = CALIB_MIN_SAMPLES
    payload = exchange_payload_bytes(num_shards, bucket_cap,
                                     value_row_bytes)
    bucket = shape_bucket(payload)
    decision: dict = {"bucket": bucket, "payload_bytes": int(payload)}
    if requested != "auto":
        decision.update(method=requested, provenance="pinned",
                        reason=f"user pinned {requested}",
                        evidence={"requested": requested})
        return decision
    evidence: dict = {}
    fallback_reason = None
    for coll in EXCHANGE_COLLECTIVE_NAMES:
        ev = collective_evidence(store, ident, coll, bucket)
        lat = interpolate_latency_ms(store, ident, coll, payload)
        evidence[coll] = {
            "predicted_ms": None if lat is None else round(lat, 4),
            "samples": ev["samples"], "by_source": ev["by_source"],
            "bucket_distance": ev["bucket_distance"],
        }
        if fallback_reason is not None:
            continue
        if lat is None or ev["bucket_distance"] is None:
            fallback_reason = (f"cold store: no sampled {coll} curve "
                               f"under this identity")
        elif ev["bucket_distance"] > 0:
            fallback_reason = (
                f"out of bucket range: nearest sampled {coll} bucket is "
                f"{ev['bucket_distance']} pow2 step(s) from {bucket} "
                "(extrapolation, not evidence)")
        elif ev["samples"] < min_samples:
            fallback_reason = (
                f"below min-samples floor: {coll}@{bucket} has "
                f"{ev['samples']} sampled latencies < {min_samples}")
    decision["evidence"] = evidence
    if fallback_reason is not None:
        decision.update(method=EXCHANGE_COLLECTIVE_NAMES[0],
                        provenance="default", reason=fallback_reason)
        return decision
    best = min(EXCHANGE_COLLECTIVE_NAMES,
               key=lambda c: evidence[c]["predicted_ms"])
    decision.update(
        method=best, provenance="curve",
        reason=(f"store curve @ {bucket}: "
                + " vs ".join(f"{c} {evidence[c]['predicted_ms']}ms"
                              for c in EXCHANGE_COLLECTIVE_NAMES)))
    return decision


def build_plan(config, workload: str, calib_prior=None,
               n_processes: int = 1) -> dict:
    """Solve the plan document for one job: per-knob choices with
    provenance + evidence, and — when the calibration store has a
    workload curve for this identity — the predicted wall decomposed
    into attribution buckets.  Read-only: consults the store and the
    process memo, mutates neither the config nor the store."""
    from map_oxidize_tpu_torch.obs import calib as _calib
    from map_oxidize_tpu_torch.obs.plan import PLAN_SCHEMA
    from map_oxidize_tpu_torch.runtime.engine import pick_device

    # the job's device, resolved now (the job resolves it anyway), so the
    # identity the plan reads curves under is the one its finish merges
    # its measurements under
    pick_device(config.backend)
    ident = _calib.run_identity(n_processes)
    shape = estimate_shape(config, workload)
    pins = _pinned_knobs(config)
    wl_curve = _calib.workload_curve(calib_prior, ident, workload)

    knobs: dict = {}

    def _knob(name, value, provenance, evidence=None):
        row = {"value": value, "provenance": provenance}
        if evidence:
            row["evidence"] = evidence
        knobs[name] = row

    # dispatch_batch — solved at the first streamed launch by the
    # dispatch resolver; the plan records where its inputs will come
    # from, pre-solving the roofline as evidence when a stored program
    # curve exists (the resolver reads the same curve, so the numbers
    # agree unless a live measurement beats the store at launch time)
    from map_oxidize_tpu_torch.runtime import dispatch as _dispatch

    prog = _BATCH_PROGRAM.get(workload)
    if "dispatch_batch" in pins:
        _knob("dispatch_batch", config.dispatch_batch, "pinned",
              {"requested": config.dispatch_batch})
    elif prog is None:
        _knob("dispatch_batch", config.dispatch_batch, "default",
              {"note": f"{workload} has no batched streamed dispatch"})
    else:
        pcurve = _calib.program_curve(calib_prior, ident, prog)
        if pcurve and pcurve.get("dispatch_ms_per_call"):
            b, rule = solve_batch(
                pcurve["dispatch_ms_per_call"],
                pcurve.get("compute_ms_per_sample"), None,
                _dispatch.DEFAULT_AUTO_B, _dispatch.MAX_AUTO_B)
            _knob("dispatch_batch", 0, "curve", {
                "program": prog,
                "floor_ms": round(pcurve["dispatch_ms_per_call"], 4),
                "curve_runs": pcurve.get("runs"),
                "planned_b": b, "rule": rule})
        elif _dispatch.has_any_cached_auto(prog):
            _knob("dispatch_batch", 0, "memo",
                  {"program": prog,
                   "note": "process memo holds a resolved B"})
        else:
            _knob("dispatch_batch", 0, "default",
                  {"program": prog,
                   "note": "no stored curve; resolver will use "
                           "platform-default floor"})

    # pipeline_depth — the one knob the plan APPLIES (via Obs.knob):
    # the workload curve's feed-wait share says whether the default
    # depth keeps the device fed
    depth = int(config.pipeline_depth)
    if "pipeline_depth" in pins:
        _knob("pipeline_depth", depth, "pinned", {"requested": depth})
    elif wl_curve:
        fw = wl_curve["buckets_ms_per_mb"].get("feed_wait", 0.0)
        share = 100.0 * fw / max(wl_curve["wall_ms_per_mb"], 1e-9)
        ev = {"feed_wait_share_pct": round(share, 2),
              "curve_runs": wl_curve["runs"]}
        if share > FEED_WAIT_DEEPEN_PCT and depth < MAX_PLANNED_DEPTH:
            ev["deepened_from"] = depth
            _knob("pipeline_depth", min(depth + 1, MAX_PLANNED_DEPTH),
                  "curve", ev)
        else:
            _knob("pipeline_depth", depth, "curve", ev)
    else:
        _knob("pipeline_depth", depth, "default")

    # chunk_bytes — advisory: record the chunk count it implies so the
    # evidence is in place for a curve
    _knob("chunk_bytes", int(config.chunk_bytes),
          "pinned" if "chunk_bytes" in pins else "default",
          {"n_chunks": shape["n_chunks"]} if shape["n_chunks"] else None)

    # shuffle_transport — applied through Obs.knob at the driver sites,
    # resolving through the same router the engines use.  A pin wins.
    # With a measured curve, an exchange share above EXCHANGE_PUSH_PCT on
    # a resident route routes to 'pipelined'.  Cold runs record 'auto'
    # as a default, never dressed as a prediction.
    if "shuffle_transport" in pins:
        _knob("shuffle_transport", config.shuffle_transport, "pinned",
              {"requested": config.shuffle_transport})
    else:
        from map_oxidize_tpu_torch.shuffle.base import resolve_transport

        cap = int(getattr(config, "collect_max_rows", 0) or 0) or (1 << 27)
        routed = resolve_transport(config, cap)
        if wl_curve:
            ex = wl_curve["buckets_ms_per_mb"].get("exchange", 0.0)
            share = 100.0 * ex / max(wl_curve["wall_ms_per_mb"], 1e-9)
            ev = {"exchange_share_pct": round(share, 2),
                  "curve_runs": wl_curve["runs"],
                  "routes_to": routed, "resident_cap": cap}
            if share > EXCHANGE_PUSH_PCT and routed in ("hbm", "hybrid"):
                ev["pushed_from"] = routed
                _knob("shuffle_transport", "pipelined", "curve", ev)
            else:
                _knob("shuffle_transport", routed, "curve", ev)
        else:
            _knob("shuffle_transport", "auto", "default",
                  {"routes_to": routed,
                   "est_rows": shape["est_rows"], "resident_cap": cap})

    # sort_sample — advisory: the curve's host_sort share is the
    # evidence a future splitter-count rule would consume
    ev = None
    if wl_curve and workload == "sort":
        hs = wl_curve["buckets_ms_per_mb"].get("host_sort", 0.0)
        ev = {"host_sort_share_pct": round(
            100.0 * hs / max(wl_curve["wall_ms_per_mb"], 1e-9), 2)}
    _knob("sort_sample", int(config.sort_sample),
          "pinned" if "sort_sample" in pins else "default", ev)

    # exchange_collective — the store-driven collective choice at this
    # job's payload bucket, refusing onto the default with a named reason
    # on cold, thin or extrapolated evidence; applied through Obs.knob at
    # every sharded engine's construction (runtime.driver.
    # solved_exchange).  The coverage plane rides along: which
    # (collective, bucket) cells this job needs vs has
    n_shards = int(getattr(config, "num_shards", 0) or 0)
    if n_shards <= 0:
        n_shards = int(ident.get("device_count") or 0) or 1
    cap_rows, row_bytes = _calib.exchange_shape(
        n_shards, int(getattr(config, "batch_size", 1) or 1),
        collect=workload in _COLLECT_WORKLOADS)
    decision = choose_collective(
        calib_prior, ident, n_shards, cap_rows, row_bytes,
        min_samples=int(getattr(config, "calib_min_samples", 0) or 0)
        or None,
        requested=str(getattr(config, "exchange_collective", "auto")
                      or "auto"))
    _knob("exchange_collective", decision["method"],
          decision["provenance"],
          {"reason": decision["reason"], "bucket": decision["bucket"],
           "payload_bytes": decision["payload_bytes"]})

    doc = {
        "schema": PLAN_SCHEMA,
        "mode": getattr(config, "plan", "auto"),
        "workload": workload,
        "identity": ident,
        "shape": shape,
        "pins": sorted(pins),
        "knobs": knobs,
        "provenance": "platform_default",
        # the full chooser decision (evidence curves included) and the
        # needs-vs-has coverage over the cells it consulted — published
        # as calib/* gauges by obs.plan.publish on EVERY planned job
        "exchange": decision,
        "coverage": _calib.coverage_report(
            calib_prior, ident,
            [{"collective": c, "bucket": decision["bucket"]}
             for c in _calib.EXCHANGE_COLLECTIVE_NAMES]
            if n_shards > 1 else [],
            min_samples=int(getattr(config, "calib_min_samples", 0)
                            or 0) or _calib.CALIB_MIN_SAMPLES),
    }
    if wl_curve and shape["corpus_bytes"] > 0:
        mb = shape["corpus_bytes"] / (1 << 20)
        doc["predicted"] = {
            "wall_ms": round(wl_curve["wall_ms_per_mb"] * mb, 3),
            "buckets": {name: round(rate * mb, 3)
                        for name, rate
                        in wl_curve["buckets_ms_per_mb"].items()},
            "curve_runs": wl_curve["runs"],
            "mean_curve_corpus_bytes": round(
                wl_curve["mean_corpus_bytes"]),
        }
        doc["provenance"] = "curve"
    return doc
