"""Milliseconds per k-means iteration: each job's ``time/iter_s`` (the
iteration chain, closed by the final centroid fetch) over its iterations,
the median over the window's jobs."""

import statistics


def read(run):
    vals = [1e3 * j["metrics"]["time/iter_s"] / j["metrics"]["iters"]
            for j in run.done if j["metrics"].get("iters")]
    return statistics.median(vals) if vals else None
