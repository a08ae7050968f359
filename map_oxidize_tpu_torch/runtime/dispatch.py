"""Dispatch-batch policy: how many logical chunks one staged block of the
streamed k-means fit retires.  The port of the JAX package's
``runtime/dispatch.py`` (``measured_dispatch_floor_ms`` :110,
``measured_compute_ms_per_chunk`` :132, ``_calib_curve`` :148,
``has_any_cached_auto`` :170, ``has_cached_auto`` :181,
``resolve_dispatch_batch`` :193, ``_resolve_auto`` :220,
``record_dispatch_batch`` :296).

* an explicit ``dispatch_batch=N`` wins verbatim (capped at the chunk
  count);
* ``0`` (auto) solves the overlap roofline
  (:func:`~map_oxidize_tpu_torch.runtime.planner.solve_batch`) from, in
  preference order: the launch ledger's measured per-dispatch gap and
  sampled device compute (a warm process), the calibration store's
  program curve (``calib_dir``: a cold process planning from the last
  run's measurements), the roofline estimate (the kernel's operations
  per chunk over the card's published peak at the fit's precision,
  :func:`~map_oxidize_tpu_torch.obs.xprof.peak_flops`), and the defaults
  last;
* the result is capped by the device-memory estimate: two staged blocks
  are in flight at once, so B may not exceed ``budget / (4 *
  chunk_bytes)``.

Auto resolutions are memoized per (program, shape, platform) for the
process lifetime, so a warm process does not flip B between jobs.  The
chosen B and every input behind it are recorded as ``dispatch/*`` and
``plan/dispatch_*`` gauges.  B is not checkpoint identity: the fit's
left fold of per-chunk partials is bit-identical at any B.
"""

from __future__ import annotations

import os
import sys
import threading

from map_oxidize_tpu_torch.obs.compile import LEDGER

#: auto fallback when nothing is measurable (no warm stats, no peak)
DEFAULT_AUTO_B = 4
#: hard auto ceiling: past it the launch floor is a sliver of block work
#: and block staging dominates
MAX_AUTO_B = 64
#: per-launch floor when nothing is measured yet: a token 1 ms where
#: dispatch is a local call (the JAX package's non-TPU default)
DEFAULT_FLOOR_MS = 1.0

_auto_cache: dict = {}
_auto_lock = threading.Lock()


def _platform() -> str:
    """``"gpu"`` once this process has initialised CUDA, else ``"cpu"``."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "gpu"
    return "cpu"


def hbm_budget_bytes() -> int:
    """Total device memory of the visible CUDA devices, read only from an
    already-initialised CUDA (never initialising it); 0 = unknown (the
    CPU)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return sum(torch.cuda.get_device_properties(i).total_memory
               for i in range(torch.cuda.device_count()))


def dispatch_floor_snapshot(program: str) -> tuple:
    """``(dispatch_ms, steady_state_dispatches)`` of ``program`` now: the
    ``since`` of :func:`measured_dispatch_floor_ms`."""
    p = LEDGER.programs.get(program)
    if p is None:
        return (0.0, 0)
    return (p.dispatch_ms, p.dispatches - p.compiles)


def measured_dispatch_floor_ms(program: str,
                               since: tuple | None = None) -> float | None:
    """Mean dispatch gap of ``program``'s non-compiling dispatches (the
    per-launch host cost), over the process lifetime or past a
    :func:`dispatch_floor_snapshot`; None until it has some."""
    p = LEDGER.programs.get(program)
    if p is None:
        return None
    ms, n = p.dispatch_ms, p.dispatches - p.compiles
    if since is not None:
        ms -= since[0]
        n -= since[1]
    if n <= 0 or ms <= 0:
        return None
    return ms / n


def measured_compute_ms_per_chunk(program: str) -> float | None:
    """Sampled device compute per logical chunk of ``program``: the mean
    sample over the observed chunks per dispatch (the samples whose CUDA
    events have completed)."""
    LEDGER.resolve()
    p = LEDGER.programs.get(program)
    if p is None or p.samples <= 0 or p.sampled_ms <= 0:
        return None
    per_dispatch = p.sampled_ms / p.samples
    n = p.dispatches - p.compiles
    cpd = (p.chunks / n) if (p.chunks and n > 0) else 1.0
    return per_dispatch / max(cpd, 1.0)


def _calib_curve(program: str) -> dict | None:
    """The calibration store's per-call figures for ``program`` under the
    current job's identity, read through the context-bound
    ``Obs.calib_prior``; None without a job, a store or a usable row."""
    from map_oxidize_tpu_torch.obs import calib as _calib
    from map_oxidize_tpu_torch.obs.context import current_obs

    obs = current_obs()
    prior = getattr(obs, "calib_prior", None)
    if prior is None:
        return None
    ident = _calib.run_identity(getattr(obs, "n_processes", 1))
    return _calib.program_curve(prior, ident, program)


def has_any_cached_auto(program: str) -> bool:
    """True when some auto resolution of ``program`` is memoized, whatever
    its shape (the planner's ``memo`` probe)."""
    platform = _platform()
    with _auto_lock:
        return any(k[0] == program and k[3] == platform
                   for k in _auto_cache)


def has_cached_auto(program: str, chunk_device_bytes: int = 0,
                    flops_per_chunk: float | None = None) -> bool:
    """True when the auto resolution of this (program, shape, platform)
    is memoized: the caller then skips the produce probe the memo would
    ignore."""
    key = (program, chunk_device_bytes, flops_per_chunk, _platform())
    with _auto_lock:
        return key in _auto_cache


def resolve_dispatch_batch(requested: int, *, n_chunks: int = 0,
                           chunk_device_bytes: int = 0,
                           flops_per_chunk: float | None = None,
                           produce_ms: float | None = None,
                           program: str = "kmeans/stream_step",
                           default_auto: int = DEFAULT_AUTO_B,
                           precision: str | None = None,
                           ) -> tuple[int, dict]:
    """The effective dispatch batch B and the evidence behind it.
    ``requested`` is the config value (0 = auto, N >= 1 pins);
    ``precision``, the fit's, picks the peak of the cold roofline
    estimate.  Returns ``(B, info)``; ``info`` carries the mode and every
    auto input for the ``dispatch/*`` record."""
    if requested >= 1:
        b = requested
        info = {"mode": "fixed", "requested": requested}
    else:
        b, info = _resolve_auto(program, chunk_device_bytes,
                                flops_per_chunk, produce_ms, default_auto,
                                precision)
    if n_chunks > 0 and b > n_chunks:
        b = n_chunks
        info["capped_by_chunks"] = n_chunks
    info["batch"] = max(b, 1)
    return max(b, 1), info


def _resolve_auto(program: str, chunk_device_bytes: int,
                  flops_per_chunk: float | None,
                  produce_ms: float | None, default_auto: int,
                  precision: str | None = None) -> tuple[int, dict]:
    # the key needs no precision: it sets the element width, so
    # ``chunk_device_bytes`` differs with it
    key = (program, chunk_device_bytes, flops_per_chunk, _platform())
    with _auto_lock:
        hit = _auto_cache.get(key)
    if hit is not None:
        return hit[0], dict(hit[1])

    info: dict = {"mode": "auto"}
    env = os.environ.get("MOXT_DISPATCH_FLOOR_MS")
    floor = None
    if env:
        try:
            floor = float(env)
            info["floor_source"] = "env"
        except ValueError:
            pass
    if floor is None:
        floor = measured_dispatch_floor_ms(program)
        if floor is not None:
            info["floor_source"] = "measured"
    curve = _calib_curve(program) if floor is None else None
    if floor is None and curve and curve.get("dispatch_ms_per_call"):
        floor = curve["dispatch_ms_per_call"]
        info["floor_source"] = "calib_curve"
    if floor is None:
        floor = DEFAULT_FLOOR_MS
        info["floor_source"] = "platform_default"
    compute = measured_compute_ms_per_chunk(program)
    if compute is not None:
        info["compute_source"] = "measured"
    else:
        if curve is None:
            curve = _calib_curve(program)
        if curve and curve.get("compute_ms_per_sample"):
            compute = curve["compute_ms_per_sample"]
            info["compute_source"] = "calib_curve"
        elif flops_per_chunk:
            from map_oxidize_tpu_torch.obs.xprof import (
                device_peaks,
                peak_flops,
            )

            peak = peak_flops(device_peaks(), precision)
            if peak:
                compute = flops_per_chunk / peak * 1e3
                info["compute_source"] = "roofline_estimate"
    info["floor_ms"] = round(floor, 4)
    if compute is not None:
        info["compute_ms_per_chunk"] = round(compute, 4)
    if produce_ms is not None:
        info["produce_ms_per_chunk"] = round(produce_ms, 4)

    from map_oxidize_tpu_torch.runtime.planner import solve_batch

    b, info["rule"] = solve_batch(floor, compute, produce_ms,
                                  default_auto, MAX_AUTO_B)

    budget = hbm_budget_bytes()
    if budget > 0 and chunk_device_bytes > 0:
        # two staged blocks in flight plus the working set: a quarter of
        # the budget per block
        cap = max(1, int(budget // (4 * chunk_device_bytes)))
        info["hbm_budget_bytes"] = budget
        info["hbm_cap"] = cap
        if b > cap:
            b = cap
            info["rule"] = info.get("rule", "") + "+hbm_capped"
    with _auto_lock:
        _auto_cache.setdefault(key, (b, dict(info)))
        hit = _auto_cache[key]
    return hit[0], dict(hit[1])


def record_dispatch_batch(registry, b: int, info: dict,
                          prefix: str = "dispatch",
                          fresh_probe_ms: float | None = None) -> None:
    """Export the decision as flat gauges: ``plan/<prefix>_batch``,
    ``plan/<prefix>_batch_mode``, ``plan/<prefix>_<input>`` and the same
    under ``<prefix>/``.  ``fresh_probe_ms``, the produce probe the
    caller just paid on the critical path, counts into
    ``attrib/probe_ms`` (the attribution's ``host_produce``); a memoized
    resolution paid nothing this run."""
    if registry is None:
        return
    for fmt in (f"{prefix}/{{}}", f"plan/{prefix}_{{}}"):
        registry.set(fmt.format("batch"), int(b))
        registry.set(fmt.format("batch_mode"), info.get("mode", "fixed"))
        for k, v in info.items():
            if k in ("mode", "batch") or v is None:
                continue
            registry.set(fmt.format(k), v)
    if fresh_probe_ms is not None and fresh_probe_ms > 0:
        registry.count("attrib/probe_ms", fresh_probe_ms)
