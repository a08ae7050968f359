"""Whole-job device trace (``trace_dir`` / ``--trace-dir``): the port of
the JAX package's ``obs/profiler.py`` ``device_trace`` (:73), on
``torch.profiler`` instead of ``jax.profiler``.

The trace records host activity and, on a CUDA device, the device's kernels
and copies (CUPTI), so the hand-written kernels show under their own names
(``kmeans_assign_sum``); it is written as Chrome trace-event JSON under the
directory.  Nothing else of the JAX module (the host sampler, on-demand
captures) is ported.
"""

from __future__ import annotations

import contextlib
import os
import time


def trace_file(log_dir: str) -> str:
    """``<log_dir>/moxt_trace_<utc>_<pid>.json``: one file per job."""
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return os.path.join(log_dir, f"moxt_trace_{stamp}_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(log_dir: str | None, cuda: bool = False):
    """Profile the block with ``torch.profiler`` and write the trace under
    ``log_dir`` (None = no-op).  ``cuda`` adds the CUDA activities.  The
    profiler stops in ``finally`` (a profiler left open after an exception
    would capture the next job too); a failure to start or to export
    raises."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = trace_file(log_dir)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
