"""Progress heartbeat: periodic rows/sec, percent-done, ETA and phase
lines (``progress`` / ``--progress``, ``--progress-interval``).  The port of
the JAX package's ``obs/heartbeat.py`` (``Heartbeat`` :23, ``announce``
:65).

Opt-in, because its audience is a human watching a long streamed job.  The
beat is driven *inline* from the driver's per-chunk/per-iteration update
calls rather than by a timer thread, so it reads the counters it reports
without extra synchronisation and is exactly reproducible under an
injected clock.
"""

from __future__ import annotations

import time

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class Heartbeat:
    """Accumulates progress; emits at most one line per ``interval_s``.

    ``clock`` and ``emit`` are injectable for tests (fake time, captured
    lines).  ``total_bytes`` (or an explicit ``fraction`` in ``update``)
    enables percent/ETA; without either, the line reports rows and rows/sec
    only.
    """

    def __init__(self, total_bytes: int | None = None,
                 interval_s: float = 10.0, clock=time.monotonic,
                 emit=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.total_bytes = total_bytes
        self.interval_s = interval_s
        self._clock = clock
        self._emit = emit if emit is not None else (
            lambda line: _log.info("%s", line))
        self._start = clock()
        self._last_beat = self._start
        self.phase = ""
        self.rows = 0
        self.bytes_done = 0
        self.fraction: float | None = None
        #: live device memory in use (max over devices), fed by the device
        #: sampler thread when one runs; None keeps it off the line
        self.hbm_bytes: int | None = None
        #: True when this heartbeat only TRACKS progress (the live plane's
        #: /status feed) and emits no lines: warning producers (the stall
        #: detector, recompile warnings) then fall back to the logger
        self.silent = False
        #: one-token wall attribution (e.g. ``compute 61%``), set by
        #: :func:`map_oxidize_tpu_torch.obs.attrib.publish`; None keeps it
        #: off the line
        self.where: str | None = None

    def announce(self, line: str) -> None:
        """Emit one out-of-band line at once (alert transitions, warnings)
        through the heartbeat's sink; the interval throttle paces only the
        periodic progress lines."""
        self._emit(line)

    def set_phase(self, name: str) -> None:
        self.phase = name

    def update(self, rows: int = 0, bytes_done: int | None = None,
               fraction: float | None = None) -> None:
        """Fold in progress from one block/iteration, then beat if the
        interval elapsed.  ``bytes_done`` is an absolute input offset
        (monotone max); ``fraction`` overrides the bytes-derived percent
        (iteration-based jobs like k-means)."""
        self.rows += rows
        if bytes_done is not None and bytes_done > self.bytes_done:
            self.bytes_done = bytes_done
        if fraction is not None:
            self.fraction = fraction
        now = self._clock()
        if now - self._last_beat >= self.interval_s:
            self._beat(now)

    def final_beat(self) -> None:
        """Unconditional closing line (jobs shorter than one interval still
        get one progress line)."""
        self._beat(self._clock())

    def _frac(self) -> float | None:
        if self.fraction is not None:
            return min(self.fraction, 1.0)
        if self.total_bytes:
            return min(self.bytes_done / self.total_bytes, 1.0)
        return None

    def _beat(self, now: float) -> None:
        self._last_beat = now
        elapsed = max(now - self._start, 1e-9)
        rate = self.rows / elapsed
        parts = [f"progress: phase={self.phase or '?'}",
                 f"rows={self.rows:,}",
                 f"({rate:,.0f} rows/s)"]
        frac = self._frac()
        if frac is not None:
            parts.append(f"{100 * frac:.1f}%")
            if 0 < frac < 1:
                eta = elapsed * (1 - frac) / frac
                parts.append(f"eta={_fmt_eta(eta)}")
        if self.hbm_bytes is not None:
            parts.append(f"hbm={self.hbm_bytes / (1 << 30):.2f}GB")
        if self.where is not None:
            parts.append(f"where={self.where}")
        self._emit(" ".join(parts))


def _fmt_eta(seconds: float) -> str:
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s // 3600}h{(s % 3600) // 60:02d}m"
