"""Host milliseconds per chunk of the device map's read and cut at
whitespace: each job's ``device_map/read_ms`` over its ``chunks``, the
median over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/read_ms", per="chunks")
