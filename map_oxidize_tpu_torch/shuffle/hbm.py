"""Strictly resident shuffle staging (a copy of the JAX package's
``shuffle/hbm.py``).

Rows stay where the engine keeps them (device buffers or host RAM); the
resident row cap is a hard error, never a silent demotion — the right
choice where a surprise disk drain mid-job is worse than an up-front
rejection.  The error names the escape hatches
(``--shuffle-transport disk|hybrid``).
"""

from __future__ import annotations

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport


class HbmTransport(ShuffleTransport):
    """RESIDENT-only: never trips to disk; the cap raises."""

    name = "hbm"

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        if resident_rows > max_rows:
            raise self.cap_error(resident_rows, max_rows, engine)
        return "resident"
