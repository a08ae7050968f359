"""Milliseconds per k-means job to read the points out of the memory map
into a new host array: each job's ``kmeans/read_points_ms``, the median
over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "kmeans/read_points_ms")
