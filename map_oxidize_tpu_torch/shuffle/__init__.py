"""Pluggable shuffle transport layer: the port's copy of the JAX
package's ``shuffle/`` (``shuffle/__init__.py``, ``base.py``, ``hbm.py``,
``hybrid.py``, ``disk.py``, ``pipelined.py``, ``remote.py``), host code
and numpy only.

The collect engines ask a transport where shuffled rows stage and what
happens at the resident-row cap; the driver picks it
(``--shuffle-transport``):

* :class:`~map_oxidize_tpu_torch.shuffle.hbm.HbmTransport` — strictly
  resident; crossing the resident-row cap is a hard, actionable error.
* :class:`~map_oxidize_tpu_torch.shuffle.disk.DiskTransport` — rows stage
  in top-bits disk buckets from the first row; bounded resident memory at
  any corpus size.
* :class:`~map_oxidize_tpu_torch.shuffle.hybrid.HybridTransport` —
  resident until the cap trips, then a one-way demotion to disk buckets
  mid-job.
* :class:`~map_oxidize_tpu_torch.shuffle.pipelined.PipelinedTransport` —
  hybrid's placement with the push cadence: the map runs ahead in the
  prefetch thread and each push window is optionally combined map-side.
* :class:`~map_oxidize_tpu_torch.shuffle.remote.RemoteTransport` — staged
  from the first row like disk (the JAX package's shared-filesystem stage
  comes with the multi-process drivers).

``auto`` routes on corpus size vs the cap (:func:`resolve_transport`).
On one device every transport runs: ``remote`` places like ``disk``.
"""

from map_oxidize_tpu_torch.shuffle.base import (
    AUTO_BYTES_PER_ROW,
    ShuffleTransport,
    TRANSPORTS,
    make_transport,
    record_demotion,
    resolve_transport,
)
from map_oxidize_tpu_torch.shuffle.disk import DiskPairStage, DiskTransport
from map_oxidize_tpu_torch.shuffle.hbm import HbmTransport
from map_oxidize_tpu_torch.shuffle.hybrid import HybridTransport
from map_oxidize_tpu_torch.shuffle.pipelined import (
    PipelinedTransport,
    combine_map_output,
    record_push_combine,
)
from map_oxidize_tpu_torch.shuffle.remote import RemoteTransport

__all__ = [
    "AUTO_BYTES_PER_ROW",
    "DiskPairStage",
    "DiskTransport",
    "HbmTransport",
    "HybridTransport",
    "PipelinedTransport",
    "RemoteTransport",
    "ShuffleTransport",
    "TRANSPORTS",
    "combine_map_output",
    "make_transport",
    "record_demotion",
    "record_push_combine",
    "resolve_transport",
]
