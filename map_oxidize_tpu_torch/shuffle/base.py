"""Shuffle transport interface (a copy of the JAX package's
``shuffle/base.py``: ``resolve_transport`` :66, ``make_transport`` :133,
``record_demotion`` :153).

A transport answers one question per fed block — *where do shuffled rows
stage?* — through a small three-state machine:

    PUSHING --(trip)--> SPILLED <--(trip: resident rows cross the cap)-- RESIDENT

``hbm`` never leaves RESIDENT (the trip is a hard error), ``disk`` and
``remote`` start in SPILLED, ``hybrid`` makes the one-way demotion
transition mid-job, and ``pipelined`` starts in PUSHING (resident
placement plus the push cadence, which is the driver's half) and takes
the same one-way demotion at the cap.  The engines own the mechanisms —
resident staging, and the top-bits disk buckets
(:mod:`map_oxidize_tpu_torch.runtime.spill`) — and consult the transport
via :meth:`ShuffleTransport.admit` before acting on a block.

Obs-counter contract (every transport/engine pair honours it):

* ``spill/rows`` / ``spill/bytes`` — rows/bytes written to disk buckets.
* ``spill/buckets`` — distinct bucket files opened.
* ``demote/events`` / ``demote/rows`` and a ``shuffle/demote`` tracer
  span — one per RESIDENT->SPILLED transition (:func:`record_demotion`).
* ``shuffle/transport`` gauge — the transport driving the job (drivers
  set it).
* data-plane audit hooks — a spilling pair stage digests every pair it
  stages and drains and raises
  :class:`~map_oxidize_tpu_torch.obs.dataplane.ConservationError` if a
  full drain returns a different multiset.

Drain-order invariant: buckets are top-bit key RANGES, so a
bucket-by-bucket drain concatenates into globally key-ascending output.
"""

from __future__ import annotations

import abc
import os

#: the ``--shuffle-transport`` vocabulary (config + CLI + serve ``--set``)
TRANSPORTS = ("auto", "hbm", "disk", "hybrid", "pipelined", "remote")

#: auto-routing density assumption: one shuffled row per this many corpus
#: bytes.  Deliberately conservative (short-token text emits a pair per
#: ~6-10 bytes): when even this UNDERestimate of the row count exceeds
#: the resident cap, the job is certainly beyond-RAM and should stage on
#: disk from the first row instead of paying a mid-job demotion drain.
AUTO_BYTES_PER_ROW = 16


def resolve_transport(config, max_rows: int, name: str | None = None) -> str:
    """Resolve ``config.shuffle_transport`` to a concrete transport name.

    ``auto`` routes on corpus size vs the resident-row cap: estimated
    rows (``corpus_bytes // AUTO_BYTES_PER_ROW``) past ``max_rows``
    pick ``disk`` (the job will certainly spill — skip the demotion
    drain and bound residency from row 0), anything else picks
    ``hybrid`` (resident speed, disk safety net) — today's engine
    behavior, now a named policy.  An unreadable input (serve jobs
    validate paths later) falls back to ``hybrid``.

    ``name`` overrides the config's spelling — the planner's
    ``Obs.knob("shuffle_transport")`` seam resolves the PLANNED name
    through the same router, so a curve-chosen ``pipelined`` and a
    pinned one take an identical path."""
    if name is None:
        name = getattr(config, "shuffle_transport", "auto")
    if name != "auto":
        return name
    try:
        size = os.path.getsize(config.input_path)
    except (OSError, TypeError):
        size = 0
    return "disk" if size // AUTO_BYTES_PER_ROW > max_rows else "hybrid"


class ShuffleTransport(abc.ABC):
    """The placement policy state machine.  Engines call :meth:`admit`
    with the prospective resident row count before acting on a block and
    act on the verdict:

    * ``"resident"`` — keep the block on the resident path (device
      buffers / host RAM staging).
    * ``"push"`` — resident placement PLUS an eager per-block push: the
      engine partitions and merges the block into its owner immediately
      instead of accumulating toward a terminal barrier (the PUSHING
      state; placement-wise engines treat it exactly like
      ``"resident"``, the push cadence is the driver's half).
    * ``"spill"`` — stage the block in disk buckets.
    * ``"demote"`` — drain the resident state to disk buckets first
      (record it via :func:`record_demotion`), then spill this block and
      every later one; returned exactly once, at the trip.
    """

    name: str = "?"

    def __init__(self) -> None:
        self.spilled_state = False

    @abc.abstractmethod
    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        """Verdict for a block that brings the resident row count to
        ``resident_rows`` against the ``max_rows`` cap.  ``engine`` names
        the caller for error messages (e.g. ``"pair collect"``)."""

    def cap_error(self, resident_rows: int, max_rows: int,
                  engine: str) -> RuntimeError:
        """The actionable strict-mode abort (``hbm`` only)."""
        return RuntimeError(
            f"{engine} exceeded max_rows={max_rows} with "
            "--shuffle-transport hbm (strictly resident, no spill); "
            "re-run with --shuffle-transport disk (disk buckets from the "
            "first row) or hybrid (resident until the cap, then demote "
            "to disk), or raise --collect-max-rows if the rows genuinely "
            "fit")


def make_transport(name: str) -> ShuffleTransport:
    """Concrete transport instance for a resolved (non-``auto``) name."""
    from map_oxidize_tpu_torch.shuffle.disk import DiskTransport
    from map_oxidize_tpu_torch.shuffle.hbm import HbmTransport
    from map_oxidize_tpu_torch.shuffle.hybrid import HybridTransport
    from map_oxidize_tpu_torch.shuffle.pipelined import PipelinedTransport
    from map_oxidize_tpu_torch.shuffle.remote import RemoteTransport

    try:
        cls = {"hbm": HbmTransport, "disk": DiskTransport,
               "hybrid": HybridTransport,
               "pipelined": PipelinedTransport,
               "remote": RemoteTransport}[name]
    except KeyError:
        raise ValueError(
            f"unknown shuffle transport {name!r}; expected one of "
            f"{TRANSPORTS}") from None
    return cls()


def record_demotion(obs, rows: int, frm: str, to: str, **attrs):
    """The one demotion record, shared by every engine so the
    single-controller and distributed paths emit IDENTICAL evidence: a
    ``shuffle/demote`` span wrapping the drain (use as a context
    manager) plus the ``demote/events`` / ``demote/rows`` counters.
    ``rows`` is the resident row count being drained."""
    import contextlib

    if obs is None:
        return contextlib.nullcontext()
    obs.registry.count("demote/events")
    obs.registry.count("demote/rows", rows)
    return obs.tracer.span("shuffle/demote", rows=rows, **{"from": frm,
                                                           "to": to},
                           **attrs)
