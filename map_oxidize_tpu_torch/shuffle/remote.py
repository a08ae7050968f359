"""Remote-staged transport (the placement half of the JAX package's
``shuffle/remote.py``: ``RemoteTransport``).

Placement-wise ``remote`` is ``disk``: SPILLED from the first row, staged
through the same top-bits bucket machinery on one process.  The JAX
module's multi-process stage (a shared-filesystem object layout under
``moxt-shuffle-stage-v1`` manifests that a surviving peer can finish a job
from) belongs to the multi-process drivers and comes with them.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport


class RemoteTransport(ShuffleTransport):
    """SPILLED from the start, like disk."""

    name = "remote"

    def __init__(self) -> None:
        super().__init__()
        self.spilled_state = True

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        return "spill"
