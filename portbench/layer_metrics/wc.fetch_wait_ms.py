"""Host milliseconds per chunk waiting for the packed fetch, one chunk
behind: each job's ``device_map/fetch_wait_ms`` over its ``chunks``, the
median over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/fetch_wait_ms", per="chunks")
