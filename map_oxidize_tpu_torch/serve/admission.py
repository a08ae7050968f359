"""HBM admission control for the resident job service: the port of the
JAX package's ``serve/admission.py`` (``probe_hbm_budget`` :39,
``measured_live_bytes`` :58, ``estimate_hbm_bytes`` :75,
``_estimate_kmeans`` :108, ``AdmissionController`` :137), on torch.

Every admitted job gets a device working-set RESERVATION sized by a
per-workload estimate; the scheduler only starts a job when its
reservation fits inside the budget next to the already-running set.
Three outcomes, all named (never a mid-run capacity abort):

* **reject** — the estimate exceeds the whole budget: the job could
  never run here, so it fails fast at submit with
  ``working_set_exceeds_hbm_budget``;
* **defer**  — the estimate fits the budget but not next to the running
  jobs' reservations (or the measured live bytes, whichever is larger):
  the job stays queued and re-evaluates every time a job finishes;
* **admit**  — reserve and run.

The budget defaults to the card's total memory, read by the dispatch
resolver's :func:`~map_oxidize_tpu_torch.runtime.dispatch.hbm_budget_bytes`
(the one definition in the port) from an already-initialised CUDA.  A
process that never initialised CUDA (the CPU) leaves admission open
unless an explicit budget is configured — the estimates are then still
recorded on every job for observability.  The live bytes are the caching
allocator's ``allocated_bytes.all.current``, the value the device sampler
records as ``hbm/live_bytes_device<i>``.

The estimates are deliberately coarse UPPER-bound models of what each
driver stages on the device (documented per workload below), the JAX
package's formulas unchanged, so the two packages decide alike for the
same config and budget; a submitter who knows better passes
``est_hbm_bytes`` explicitly and that wins.  The live check uses
``max(reserved, measured)`` so a foreign allocation on a shared card
defers new work instead of colliding with it.
"""

from __future__ import annotations

import os
import sys

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


def probe_hbm_budget() -> int:
    """Total memory (bytes) of the visible CUDA devices, via
    :func:`~map_oxidize_tpu_torch.runtime.dispatch.hbm_budget_bytes`:
    only from an already-initialised CUDA — admission must never
    initialise the card itself (the resident server warms it off-path at
    start, so on a card host the probe succeeds before the first
    submission).  0 when unknown (CUDA not initialised, or the CPU)."""
    from map_oxidize_tpu_torch.runtime.dispatch import hbm_budget_bytes

    return hbm_budget_bytes()


def measured_live_bytes() -> int:
    """Sum of live device bytes right now over the visible CUDA devices
    (the caching allocator's ``allocated_bytes.all.current``, the reading
    the device sampler records as ``hbm/live_bytes_device<i>``); 0 when
    CUDA is not initialised."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return sum(int(torch.cuda.memory_stats(i).get(
                   "allocated_bytes.all.current", 0))
               for i in range(torch.cuda.device_count()))


def estimate_hbm_bytes(config, workload: str) -> int:
    """Coarse upper-bound device working set for one job, from its config.

    Models (per driver, see runtime/driver.py and runtime/engine.py):

    * fold workloads (wordcount, bigram on the fold engine): the device
      accumulator at full ``key_capacity`` (hi/lo u32 keys + value +
      grow slack ~16B/row) plus one padded feed batch (~16B/row);
    * distinct: ``2^p`` registers are KBs — the batch staging dominates;
    * invertedindex: collect staging batches (~24B/pair-row); the
      default host sort keeps the pair store off-device;
    * kmeans: the driver's own fit accounting — ``4n(d + 2k)`` when the
      HBM-resident fit applies, else one streamed chunk's working set
      (the 256MB-floored chunk staging, same formula per chunk).
    """
    if workload == "kmeans":
        return _estimate_kmeans(config)
    batch = int(config.batch_size) * 16
    if workload == "distinct":
        return (1 << config.hll_precision) * 8 + batch
    if workload == "invertedindex":
        return int(config.batch_size) * 24
    if workload in ("sort", "join", "sessionize"):
        # pair-collect staging: one padded (4, B) exchange block plus
        # the per-shard receive buffers' next-block headroom (~24B/row,
        # the invertedindex model — the dataflow workloads ride the
        # same engine family; spilled rows live on disk, not HBM)
        return int(config.batch_size) * 24
    # wordcount / bigram: fold accumulator + feed staging (the collect
    # route stages even less on device, so this stays an upper bound)
    return int(config.key_capacity) * 16 + batch


def _estimate_kmeans(config) -> int:
    import numpy as np
    import torch

    from map_oxidize_tpu_torch.runtime.driver import _kmeans_device_fit_bytes

    k = int(config.kmeans_k)
    try:
        with open(config.input_path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _fortran, dtype = np.lib.format._read_array_header(
                f, version)
        n, d = int(shape[0]), int(shape[1])
    except Exception:
        # unreadable header: assume f32 rows of dim 32 for sizing only
        size = 0
        try:
            size = os.path.getsize(config.input_path)
        except OSError:
            pass
        d = 32
        n = max(size // (4 * d), 1)
    full_fit = 4 * n * (d + 2 * k)
    # the driver's budget on the card the job would run on; a process
    # that has not initialised CUDA takes the CPU's constant (the JAX
    # package's fallback for a device without memory stats)
    dev = (torch.device("cuda", 0)
           if config.backend == "cuda" and torch.cuda.is_initialized()
           else torch.device("cpu"))
    if full_fit <= _kmeans_device_fit_bytes(config, dev):
        return full_fit
    # streamed-through-device: one chunk's staging (driver floors the
    # chunk at 256MB of points for dispatch amortization)
    chunk_rows = max(1, max(config.chunk_bytes, 256 << 20)
                     // (4 * (d + 2 * k)))
    return 4 * chunk_rows * (d + 2 * k)


class AdmissionController:
    """Reservation ledger + the admit/defer/reject decision.

    NOT internally locked: the scheduler calls every method under its own
    condition lock (decisions and reservations must be atomic with queue
    state anyway).  Because those calls hold that lock, nothing here may
    block on the backend: device probes/reads only happen after
    :meth:`mark_backend_ready` — which the resident server's warm-up
    thread calls once CUDA has actually initialised, so every later
    ``memory_stats`` read is a lookup, never an initialisation."""

    def __init__(self, budget_bytes: int = 0):
        self._explicit = budget_bytes > 0
        self.budget = budget_bytes
        self.reserved = 0
        self._probed = False
        self._ready = False

    def mark_backend_ready(self) -> None:
        """The backend finished initializing (the server's warm-up
        thread): device probes are cheap from now on.  Probes the budget
        immediately, off the scheduler lock."""
        self._ready = True
        self._ensure_budget()

    def _ensure_budget(self) -> int:
        """Probe once the backend is warm; an explicit budget never
        probes.  Until then the budget reads 0 (admission open) — the
        warm-up runs at server start, so on accelerator hosts the window
        closes before the first realistic submission."""
        if not self._explicit and not self._probed and self._ready:
            probed = probe_hbm_budget()
            if probed > 0:
                self.budget = probed
                self._probed = True
                _log.info("[serve] probed HBM admission budget: %.2f GB",
                          probed / (1 << 30))
        return self.budget

    def decide(self, est_bytes: int) -> tuple[str, str]:
        """One admission decision: ``("admit"|"defer"|"reject", reason)``.
        A zero budget (unprobeable backend, e.g. CPU) admits everything —
        the estimates still ride the job records as evidence."""
        budget = self._ensure_budget()
        if budget <= 0:
            return "admit", ""
        if est_bytes > budget:
            return ("reject",
                    f"working_set_exceeds_hbm_budget: estimated "
                    f"{est_bytes} B working set > {budget} B budget")
        in_use = max(self.reserved,
                     measured_live_bytes() if self._ready else 0)
        if est_bytes + in_use > budget:
            return ("defer",
                    f"hbm_budget_busy: estimated {est_bytes} B + "
                    f"{in_use} B in use > {budget} B budget")
        return "admit", ""

    def reserve(self, est_bytes: int) -> None:
        self.reserved += max(est_bytes, 0)

    def release(self, est_bytes: int) -> None:
        self.reserved = max(self.reserved - max(est_bytes, 0), 0)

    def doc(self) -> dict:
        """The /jobs header's admission snapshot."""
        return {
            "budget_bytes": self._ensure_budget(),
            "reserved_bytes": self.reserved,
            "measured_live_bytes": (measured_live_bytes()
                                    if self._ready else 0),
        }
