"""Milliseconds per k-means job to read the points and copy them to the
card: each job's ``time/transfer_s``, the median over the window's jobs."""

import statistics


def read(run):
    vals = [1e3 * j["metrics"]["time/transfer_s"] for j in run.done
            if "time/transfer_s" in j["metrics"]]
    return statistics.median(vals) if vals else None
