"""Hybrid transport: resident speed, disk safety net (a copy of the JAX
package's ``shuffle/hybrid.py``).

Starts resident and makes the one-way RESIDENT -> SPILLED transition when
the resident row count crosses the cap: the engine drains its resident
state into disk buckets (under a ``shuffle/demote`` span,
:func:`map_oxidize_tpu_torch.shuffle.base.record_demotion`) and stages
every later block there.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport


class HybridTransport(ShuffleTransport):
    """RESIDENT until the cap trips, then SPILLED for good."""

    name = "hybrid"

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        if self.spilled_state:
            return "spill"
        if resident_rows > max_rows:
            self.spilled_state = True
            return "demote"
        return "resident"
