"""Host milliseconds per chunk to enqueue the device map's work: the
tokenizer, the fold (with any growth sync) and the packed copy.  Each
job's ``device_map/enqueue_ms`` over its ``chunks``, the median over the
window's jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/enqueue_ms", per="chunks")
