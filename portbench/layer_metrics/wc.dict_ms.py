"""Host milliseconds per chunk of the dictionary update from the packed
rows (with an overflow fetch): each job's ``device_map/dict_ms`` over its
``chunks``, the median over the window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/dict_ms", per="chunks")
