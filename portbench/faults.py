"""Faults planted in the program under test, to show that the comparison
catches them.  The calibration script (``calibrate.py``) reads them on the
card at a cell's own size and the harness's tests (``tests/``) on the
CPU; the benchmark's runs never plant one.

Each fault is named by what it breaks, as a job kind's timed path can
have it:

- ``unchanged_step``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out, the rest reduced alone;
- ``altered_answer``: answers altered where they are written (one word's
  count; one value of each of the first 1% of the centroids).

(Every cell runs on one card, so no cell has an exchange between cards to
leave out.)
"""

from __future__ import annotations

import contextlib

import numpy as np


def _kmeans(name: str):
    from map_oxidize_tpu_torch.workloads import kmeans as km

    if name == "unchanged_step":
        return km, "_kmeans_step_impl", lambda c, p, k, precision="highest": c
    if name == "half_batch":
        step = km._kmeans_step_impl
        return km, "_kmeans_step_impl", (
            lambda c, p, k, precision="highest":
            step(c, p[:p.shape[0] // 2], k, precision))
    if name == "altered_answer":
        write = km.write_centroids

        def altered(path, centroids):
            # one value of each of the first 1% of the centroids (at
            # least one) off by one unit where the table is written
            c = np.array(centroids, np.float32)
            c[:max(1, c.shape[0] // 100), 0] += 1.0
            write(path, c)
        return km, "write_centroids", altered
    raise KeyError(name)


def _wordcount(name: str):
    from map_oxidize_tpu_torch.runtime import device_map as dm

    if name == "unchanged_step":
        return (dm.DeviceReduceEngine, "feed_device",
                lambda self, *a, **k: None)
    if name == "half_batch":
        chunks = dm.iter_chunks_capped

        def every_other(*a, **k):
            for i, c in enumerate(chunks(*a, **k)):
                if i % 2 == 0:
                    yield c
        return dm, "iter_chunks_capped", every_other
    if name == "altered_answer":
        write = dm.write_final_result

        def altered(path, items):
            items = sorted(items)
            w, c = items[0]
            return write(path, [(w, c + 1)] + items[1:])
        return dm, "write_final_result", altered
    raise KeyError(name)


_JOBS = {"kmeans": _kmeans, "wordcount": _wordcount}
NAMES = ("unchanged_step", "half_batch", "altered_answer")


def names(job: str) -> tuple[str, ...]:
    """The faults a job kind's cells can have."""
    return NAMES if job in _JOBS else ()


@contextlib.contextmanager
def planted(name: str | None, job: str | None = None):
    """Plant fault ``name`` of ``job`` (by default the one whose module
    has it) for the body; ``None`` plants nothing."""
    if name is None:
        yield
        return
    owner, attr, value = _JOBS[job](name)
    saved = owner.__dict__[attr]
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
