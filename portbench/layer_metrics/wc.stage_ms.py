"""Host milliseconds per chunk of the device map's staging: the pad and the
copy into the pinned ring, with the wait for the ring's slot.  Each job's
``device_map/stage_ms`` over its ``chunks``, the median over the window's
jobs."""

from portbench.counters import median


def read(run):
    return median(run, "device_map/stage_ms", per="chunks")
