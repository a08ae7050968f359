"""Milliseconds per k-means job to copy the points to the card and sync:
each job's ``kmeans/copy_points_ms``, the median over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "kmeans/copy_points_ms")
