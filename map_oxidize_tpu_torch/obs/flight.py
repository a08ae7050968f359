"""Failure flight recorder: post-mortem evidence for aborted jobs.  The
port of the JAX package's ``obs/flight.py`` (``record_failure`` :50).

:func:`record_failure` is the except-path twin of ``Obs.finish``: it closes
still-open spans (on every thread, so the trace stays well-formed), stops
the live plane (JAX :68-71), attributes the wall as of the abort, snapshots memory watermarks, flushes
the partial metrics and trace to the ``metrics_out`` / ``trace_out`` paths
the run asked for, and dumps one bundle per crash under ``crash_dir``:

* ``error.json``   — exception type/message/traceback, run metadata
  (version, config hash, workload), full config;
* ``metrics.json`` — the metrics document as of the crash, with the
  ``series`` and ``alerts`` sections when the live plane ran (JAX
  :99-104);
* ``trace.json``   — Chrome trace-event JSON with the interrupted spans
  closed at crash time and tagged ``unfinished`` (only when the run
  traced).

Every step is best-effort: a recorder error never masks the original
exception.  The multi-process shard branch comes with the multi-process
drivers.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


def crash_bundle_dir(crash_dir: str, process: int = 0) -> str:
    """``<crash_dir>/crash_<utc>_p<proc>_<pid>``."""
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return os.path.join(crash_dir,
                        f"crash_{stamp}_p{process}_{os.getpid()}")


def record_failure(obs, config, exc: BaseException,
                   workload: str | None = None) -> str | None:
    """Dump the post-mortem bundle; returns its directory (None when no
    ``crash_dir`` is configured).  Never raises."""
    try:
        return _record(obs, config, exc, workload)
    except Exception as rec_err:  # a recorder error must not mask exc
        _log.warning("flight recorder failed (%s); original error "
                     "propagates", rec_err)
        return None


def _record(obs, config, exc, workload):
    from map_oxidize_tpu_torch.obs import attrib, write_json_atomic
    from map_oxidize_tpu_torch.obs.ledger import config_hash
    from map_oxidize_tpu_torch.obs.metrics import (
        sample_device_memory,
        sample_host_memory,
    )

    err = f"{type(exc).__name__}: {exc}"
    obs.tracer.close_open_spans(error=err)
    # the live plane shuts down FIRST: the status server must not serve a
    # half-recorded crash, and the time-series recorder takes its final
    # sample so the bundle's series ends at the crash instant
    obs.stop_live()
    # the launch-ledger window closes here too: the compile and dispatch
    # record as of the crash lands in the bundle
    xprof_report = obs.finish_xprof()
    attrib_doc = attrib.finalize(
        obs, xprof_report, max(time.time() - obs.tracer.wall_start, 1e-9))
    sample_host_memory(obs.registry)
    sample_device_memory(obs.registry)
    obs.registry.set("aborted", True)

    meta = obs.stamp(config, workload)
    metrics_doc = dict(obs.registry.to_dict(), meta=meta)
    metrics_doc["attrib"] = attrib_doc
    if xprof_report is not None:
        metrics_doc["xprof"] = xprof_report
    if obs.series is not None:
        metrics_doc["series"] = obs.series.export()
    if obs.alerts is not None:
        # which SLOs were firing when the job died
        metrics_doc["alerts"] = obs.alerts.export()
    trace = obs.tracer.chrome_trace() if obs.tracer.enabled else None
    if trace is not None:
        trace.insert(0, {"name": "moxt_meta", "ph": "M",
                         "pid": obs.tracer._pid, "tid": 0,
                         "args": dict(meta, aborted=True)})

    # honour the run's own artifact flags with the partial documents
    if config.metrics_out:
        write_json_atomic(config.metrics_out, metrics_doc)
    if trace is not None and config.trace_out and config.trace_out != "-":
        write_json_atomic(config.trace_out, trace, indent=None)

    if not config.crash_dir:
        return None
    bundle = crash_bundle_dir(config.crash_dir, obs.process)
    os.makedirs(bundle, exist_ok=True)
    write_json_atomic(os.path.join(bundle, "error.json"), {
        "error": err,
        "traceback": "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)),
        "meta": meta,
        "config": dataclasses.asdict(config),
        "config_hash": config_hash(config),
    })
    write_json_atomic(os.path.join(bundle, "metrics.json"), metrics_doc)
    if trace is not None:
        write_json_atomic(os.path.join(bundle, "trace.json"), trace,
                          indent=None)
    _log.error("job aborted (%s); flight-recorder bundle: %s", err, bundle)
    return bundle
