"""Host milliseconds per chunk of the overflow fetch (the side-stream copy
of the unique rows past the packed window, inside the dict step): each
job's ``device_map/overflow_ms`` over its ``chunks``, the median over the
window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/overflow_ms", per="chunks")
