"""Milliseconds per job of the device map's readback in finalize (the
engine's finalize and its fetch, the live rows joined to the host
dictionary): each job's ``device_map/readback_ms``, the median over the
window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/readback_ms")
