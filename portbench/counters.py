"""The port's own per-job counters, as the per-layer metrics read them:
the median over the window's jobs of a counter, or of a counter over
another (per chunk).  A job without the counter (a port that lacks it)
gives nothing, and a window of such jobs gives None."""

from __future__ import annotations

import statistics


def median(run, key: str, per: str | None = None):
    vals = [j["metrics"][key] / (j["metrics"][per] if per else 1)
            for j in run.done
            if key in j["metrics"] and (per is None or j["metrics"].get(per))]
    return statistics.median(vals) if vals else None
