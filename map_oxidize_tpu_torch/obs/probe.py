"""Collective calibration probe: deterministic microbenchmarks that fill
the calibration store's collective curves without waiting for jobs.

The port of the JAX package's ``obs/probe.py``.  The exchange-collective
chooser (``runtime/planner.py`` ``choose_collective``) refuses to
substitute until the job's exact payload bucket has enough sampled
latencies, so on a fresh store the first jobs always run the default.
``obs calib probe`` closes the loop by sweeping the framework's own
collective programs on the mesh the jobs will use —

* ``shuffle/merge``'s exchange under the monolithic ``all_to_all``,
* the same exchange under the ``all_gather`` + slice decomposition,
* the merge step's ``psum`` counter reduction,
* the two-level top-k's candidate ``all_gather`` (``shuffle/top_k``),

across power-of-two payload buckets, and merges the rows into the store
through the same machinery as job evidence, tagged ``source: "probe"``.

Inputs are seeded (``numpy.random.default_rng(0)``) and the bucket ->
buffer-shape derivation is the engines' payload identity
(``exchange_payload_bytes``).  Under a process group the probe sweeps the
global mesh: every process builds the same seeded global inputs, feeds
its local slots their rows, and runs the identical sweep in lockstep, so
two processes probing into two stores write identical row sets.  A rep's latency is the wall of one call
with the devices synchronised after it: the exchange rows time the
``_exchange`` body the merge step runs, without the segment-combine.
"""

from __future__ import annotations

import os
import time

import numpy as np

#: default payload sweep: every pow2 bucket a small-to-medium job's
#: exchange lands in
DEFAULT_BUCKETS = ("16KB", "32KB", "64KB", "128KB", "256KB",
                   "512KB", "1MB", "2MB", "4MB")
#: timed repetitions per (program, bucket): above the chooser's
#: CALIB_MIN_SAMPLES floor, so one probe makes cells selectable
DEFAULT_REPS = 5
#: the fold engine's word-count value plane (int32 counts): the probe
#: prices the payload identity the engines record
PROBE_VALUE_ROW_BYTES = 4


def _cap_for_bucket(bucket: str, num_shards: int,
                    row_bytes: int = PROBE_VALUE_ROW_BYTES) -> int | None:
    """Smallest exchange-buffer cap whose payload identity lands at or
    above ``bucket``'s floor."""
    from map_oxidize_tpu_torch.obs.calib import bucket_index

    k = bucket_index(bucket)
    if k is None:
        return None
    target = 1 << k
    unit = num_shards * num_shards * (8 + row_bytes)
    return max(1, -(-target // unit))


def _probe_inputs(num_shards: int, cap: int, rng) -> tuple:
    """Seeded exchange planes: B = S*cap//2 real rows per shard (expected
    bucket load cap/2, no overflow), global row-major."""
    B = max(num_shards, num_shards * cap // 2)
    n = num_shards * B
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    vals = np.ones(n, dtype=np.int32)
    return hi, lo, vals


def _time_reps(mesh, fn, inputs, reps: int) -> list:
    """One untimed call (the first call builds what it needs), then
    ``reps`` timed walls (ms), each with the mesh's devices synchronised
    after the call."""
    import torch

    cards = sorted({d for d in mesh.devices if d.type == "cuda"},
                   key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    fn(*inputs)
    sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*inputs)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def run_probe(store_dir: str, num_shards: int = 0,
              buckets=DEFAULT_BUCKETS, reps: int = DEFAULT_REPS,
              n_processes: int = 1, backend: str = "auto") -> dict:
    """Sweep the collective programs across ``buckets`` on a mesh of
    ``num_shards`` slots over ``backend`` ('cuda', 'cpu', or 'auto': the
    cards when the host has one, else the CPU) and merge the measured
    rows into ``store_dir``'s calibration store with ``source="probe"``.
    Returns the summary document ``obs calib probe`` renders."""
    import torch

    from map_oxidize_tpu_torch.obs import calib as _calib
    from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
    from map_oxidize_tpu_torch.ops.segment_reduce import keys_from_planes
    from map_oxidize_tpu_torch.parallel.mesh import (
        SHARD_AXIS,
        all_gather,
        make_mesh,
        psum,
    )
    from map_oxidize_tpu_torch.parallel.shuffle import (
        EXCHANGE_COLLECTIVES,
        _exchange,
        _local_top_k,
        exchange_payload_bytes,
    )

    if backend == "auto":
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cpu":
        _calib.note_cpu_device()
    mesh = make_mesh(num_shards, backend=backend)
    if backend == "cuda":
        torch.cuda.init()
    S = mesh.shape[SHARD_AXIS]
    reg = MetricsRegistry()
    rng = np.random.default_rng(0)
    cells = []

    def _shards(a: np.ndarray) -> list:
        # this process's local slots' rows of the global row-major array
        per = a.shape[0] // S
        lo = mesh.offset * per
        return mesh.split(torch.from_numpy(a[lo:lo + mesh.n_local * per]))

    def _cell(collective, program, payload, walls, shape):
        for ms in walls:
            reg.comm(collective, program, payload, shape=shape,
                     latency_ms=ms)
        cells.append({"collective": collective, "program": program,
                      "bucket": _calib.shape_bucket(payload),
                      "payload_bytes": payload, "reps": len(walls),
                      "mean_ms": round(float(np.mean(walls)), 4)})

    # --- the exchange pair: both wire programs at every bucket ----------
    probed_caps = set()
    for bucket in buckets:
        cap = _cap_for_bucket(bucket, S)
        if cap is None or cap in probed_caps:
            continue  # tiny buckets collapse onto the same cap=1 shape
        probed_caps.add(cap)
        payload = exchange_payload_bytes(S, cap, PROBE_VALUE_ROW_BYTES)
        hi, lo, vals = _probe_inputs(S, cap, rng)
        inputs = (_shards(keys_from_planes(hi, lo)), _shards(vals))
        for method in EXCHANGE_COLLECTIVES:
            walls = _time_reps(
                mesh, lambda k, v, _c=cap, _m=method: _exchange(
                    mesh, k, v, _c, method=_m), inputs, reps)
            _cell(method, "shuffle/merge", payload, walls, (S, cap))

    # --- psum: the merge step's counter reduction -----------------------
    # payload identity as the engine's: n int32 values on each of S
    # shards, replicated -> 4*n*S*S bytes
    probed_psum = set()
    for bucket in buckets:
        k = _calib.bucket_index(bucket)
        if k is None:
            continue
        n = max(1, -(-(1 << k) // (4 * S * S)))
        if n in probed_psum:
            continue
        probed_psum.add(n)
        payload = 4 * n * S * S
        x = mesh.replicate(torch.ones(n, dtype=torch.int32).to(
            mesh.devices[0]))
        walls = _time_reps(mesh, lambda v: psum(mesh, v), (x,), reps)
        _cell("psum", "shuffle/merge", payload, walls, (n,))

    # --- the top-k candidate all_gather (the two-level top-k's wire) ----
    probed_topk = set()
    for bucket in buckets:
        k_idx = _calib.bucket_index(bucket)
        if k_idx is None:
            continue
        k_local = max(1, -(-(1 << k_idx)
                           // (S * S * (8 + PROBE_VALUE_ROW_BYTES))))
        if k_local in probed_topk:
            continue
        probed_topk.add(k_local)
        payload = S * S * k_local * (8 + PROBE_VALUE_ROW_BYTES)
        n = S * k_local
        g_hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        g_lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        g_vals = rng.integers(1, 1 << 20, size=n, dtype=np.int32)
        inputs = (_shards(keys_from_planes(g_hi, g_lo)), _shards(g_vals))

        def topk_body(keys, vals, _k=k_local):
            gk = all_gather(mesh, keys, tiled=True)[0]
            gv = all_gather(mesh, vals, tiled=True)[0]
            return _local_top_k(gk, gv, _k)

        walls = _time_reps(mesh, topk_body, inputs, reps)
        _cell("all_gather", "shuffle/top_k", payload, walls, (S, k_local))

    # --- merge into the store through the normal machinery --------------
    ident = _calib.run_identity(max(n_processes, mesh.n_processes))
    path = os.path.join(store_dir, _calib.CALIB_FILE)
    store = _calib.CalibStore(path=path)
    touched = store.accumulate_run(ident, reg.comms_table(), None,
                                   source="probe")
    store.save_merged()
    return {
        "schema": "moxt-calib-probe-v1",
        "identity": ident,
        "store": path,
        "num_shards": S,
        "reps": int(reps),
        "rows_merged": touched,
        "store_runs": store.doc.get("runs", 0),
        "cells": cells,
    }


def render_probe(summary: dict) -> str:
    """Human-readable probe report (``obs calib probe``)."""
    from map_oxidize_tpu_torch.obs.metrics import format_bytes

    ident = summary.get("identity") or {}
    lines = [
        f"calibration probe: {summary['rows_merged']} store rows merged "
        f"into {summary['store']} "
        f"({ident.get('platform')}/{ident.get('topology')}, "
        f"{summary['num_shards']} shards, {summary['reps']} reps/cell)",
        f"  {'collective':<11} {'program':<15} {'bucket':>7} "
        f"{'payload':>10} {'reps':>5} {'mean_ms':>9}",
    ]
    for c in summary.get("cells") or []:
        lines.append(
            f"  {c['collective']:<11} {c['program']:<15} "
            f"{c['bucket']:>7} {format_bytes(c['payload_bytes']):>10} "
            f"{c['reps']:>5} {c['mean_ms']:>9.3f}")
    return "\n".join(lines)
