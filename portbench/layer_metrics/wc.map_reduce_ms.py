"""Milliseconds of the device map per word-count job: each job's
``time/map+reduce_s``, the median over the window's jobs."""

import statistics


def read(run):
    vals = [1e3 * j["metrics"]["time/map+reduce_s"] for j in run.done
            if "time/map+reduce_s" in j["metrics"]]
    return statistics.median(vals) if vals else None
