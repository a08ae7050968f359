"""Milliseconds of each k-means job's envelope (``obs/setup``: the
observability set-up and the plan; ``obs/finish``: the attribution, the
critical path and the calibration merge): each job's
``obs/envelope_ms``, the median over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "obs/envelope_ms")
