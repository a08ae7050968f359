"""The resident job server: the port of the JAX package's
``serve/server.py`` (``ResidentServer`` :42, ``install_signal_handlers``
:193), with its own warm-up on the card.

``python -m map_oxidize_tpu_torch serve`` keeps ONE process alive across
jobs, so everything a cold job pays once per run is paid once per server:

* CUDA's initialisation (at server start, off the serving path);
* the launch ledger's program signatures — a "compile" in the port is a
  program's first call under a new signature, and the ledger is
  process-global, so N back-to-back same-shape jobs compile exactly once
  (per job: ``compile/total_compiles == 0`` from job 2 on);
* the loaded kernel libraries (``ops/build.py``: built or loaded by the
  first job that launches them, then held by the process);
* opened corpora (:mod:`map_oxidize_tpu_torch.serve.corpus`).

The server owns one obs bundle of its own (uptime /status, the device
sampler feeding admission evidence, a time-series ring) and ONE HTTP
plane — the :class:`~map_oxidize_tpu_torch.obs.serve.ObsServer` with the
scheduler attached, so ``/metrics /status /series`` and ``/jobs
/jobs/<id> + submit/cancel/shutdown`` share a port.

Lifecycle: ``serve_forever`` blocks until a shutdown request (SIGTERM /
SIGINT via :func:`install_signal_handlers`, or ``POST /shutdown``), then
drains — running and admitted jobs finish (bounded by
``drain_timeout_s``), new submissions reject with ``server_draining``,
per-job ledgers/metrics docs flush as each job ends, and the HTTP plane
stops last so a watcher sees the drain happen.
"""

from __future__ import annotations

import os
import signal
import threading

from map_oxidize_tpu_torch.config import JobConfig, ServeConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs.serve import ObsServer
from map_oxidize_tpu_torch.serve.scheduler import Scheduler
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


class ResidentServer:
    """One resident serving process: scheduler + obs bundle + HTTP plane.

    Construct-and-start; ``submit``/``wait``/``cancel`` delegate to the
    scheduler for in-process embedders (the bench harness, tests), HTTP
    clients go through :class:`map_oxidize_tpu_torch.serve.client.ServeClient`.
    """

    def __init__(self, cfg: ServeConfig, runner=None):
        self.cfg = cfg.validate()
        self.scheduler = Scheduler(cfg, runner=runner)
        # the server's own obs bundle: a synthetic job config switches on
        # the time-series ring + HBM sampler (admission evidence) but NOT
        # a second HTTP server — this class owns the one plane below.
        # The SLO evaluator rides the same ring; serve-scoped rules
        # (queue-wait p95, warm recompiles, HBM watermark) arm because
        # the bundle's workload is "serve", and incident bundles land in
        # the spool
        self._obs_config = JobConfig(
            input_path="", output_path="", metrics=False,
            obs_port=-1, obs_sample_s=cfg.obs_sample_s,
            hbm_sample_s=cfg.obs_sample_s,
            slo_rules=cfg.slo_rules or None,
            incident_dir=os.path.join(cfg.spool_dir, "incidents"),
            # on-demand POST /profile captures (deep profiling plane)
            # spool under the server's artifact root — process-wide
            # captures, so they live beside the jobs, not inside one
            profile_dir=os.path.join(cfg.spool_dir, "profiles"),
        )
        self.obs = Obs.from_config(self._obs_config)
        self.obs.workload = "serve"
        # per-job SLO latency metrics + the warm-recompile counter land
        # on THIS registry, where the ring and the evaluator watch them
        self.scheduler.server_registry = self.obs.registry
        self.http = ObsServer(self.obs, self._obs_config, cfg.port,
                              host=cfg.host, scheduler=self.scheduler)
        # finish/stop_live (and the flight recorder, were the server body
        # ever aborted) shut the shared plane down exactly once
        self.obs.server = self.http
        self._stopped = threading.Event()

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "ResidentServer":
        self.http.start()
        self._publish_port_record()
        self.scheduler.start()
        # warm the card off the serving path: the resident server exists
        # to pay CUDA's initialisation once, and the admission budget can
        # only be read from an initialised CUDA — without this, every
        # submission before the FIRST job ran would be admitted unchecked
        # (the probe in admission.py deliberately never initialises CUDA)
        threading.Thread(target=self._warm_backend, daemon=True,
                         name="serve-warmup").start()
        _log.info("[serve] resident job server ready on %s "
                  "(/jobs to submit)", self.http.url)
        return self

    def _warm_backend(self) -> None:
        try:
            import torch

            torch.cuda.init()
            n = torch.cuda.device_count()
            _log.info("[serve] CUDA warm: %d device(s)", n)
        except Exception as e:  # no card is a servable state (the CPU
            # tests): admission stays open, and a job that asks for
            # backend='cuda' still raises in pick_device
            _log.warning("[serve] CUDA warmup failed: %s", e)
        else:
            # only now may admission touch the devices: decide() runs
            # under the scheduler lock, so probes/reads must be
            # cached-client lookups, never a blocking backend init
            self.scheduler.admission.mark_backend_ready()
            # publish the probed budget as a gauge: the hbm-watermark
            # SLO rule evaluates live HBM as a fraction of it (the rule
            # stays dormant while the denominator is absent/zero)
            try:
                budget = self.scheduler.admission.doc().get(
                    "budget_bytes") or 0
                if budget:
                    self.obs.registry.set("hbm/budget_bytes", budget)
            except Exception as e:  # pragma: no cover - defensive
                _log.debug("budget gauge publish failed: %s", e)

    def _publish_port_record(self) -> None:
        """Write ``<spool>/obs_port.json`` (``moxt-obs-port-v1``) so a
        fleet collector pointed at the spool (``obs fleet --spool``)
        finds this server's bound port without flags.  Removed on clean
        shutdown; a killed server leaves it behind, which is how the
        collector tells "exited" (record gone -> target departed) from
        "died" (record present, endpoint dead -> stale + fleet alert)."""
        from map_oxidize_tpu_torch import __version__
        from map_oxidize_tpu_torch.obs import write_json_atomic
        from map_oxidize_tpu_torch.obs.serve import PORT_RECORD_SCHEMA

        path = os.path.join(self.cfg.spool_dir, "obs_port.json")
        try:
            os.makedirs(self.cfg.spool_dir, exist_ok=True)
            write_json_atomic(path, {
                "schema": PORT_RECORD_SCHEMA,
                "version": __version__,
                "pid": os.getpid(),
                "kind": "serve",
                "host": self.http.host,
                "port": self.http.port,
                "url": self.http.url,
                "started_unix_s": round(self.scheduler.started_at, 3),
            })
            self._port_record = path
        except OSError as e:  # discovery is best-effort
            _log.warning("cannot publish serve port record %s: %s",
                         path, e)
            self._port_record = None

    @property
    def url(self) -> str:
        return self.http.url

    def serve_forever(self) -> None:
        """Block until a shutdown request, then drain and stop.  (A
        non-drain request already cancelled everything, so the drain
        below finds an empty queue either way.)"""
        self.scheduler.shutdown_requested.wait()
        self.shutdown(drain=True)

    def shutdown(self, drain: bool = True) -> None:
        """Drain the scheduler, then stop the telemetry/job plane and the
        server obs bundle.  Idempotent."""
        if self._stopped.is_set():
            return
        self.scheduler.shutdown(drain=drain)
        self.obs.finish(self._obs_config, "serve")
        if getattr(self, "_port_record", None):
            try:
                os.unlink(self._port_record)
            except OSError:
                pass
        self._stopped.set()
        _log.info("[serve] resident job server stopped")

    # --- in-process submission (bench, tests, embedders) ------------------

    def submit(self, workload: str, input_path: str, **kw):
        return self.scheduler.submit(workload, input_path, **kw)

    def wait(self, job_id: str, timeout: float | None = None):
        return self.scheduler.wait(job_id, timeout=timeout)

    def cancel(self, job_id: str, reason: str = "cancelled_by_client"):
        return self.scheduler.cancel(job_id, reason=reason)


def install_signal_handlers(server: ResidentServer) -> None:
    """SIGTERM and SIGINT request a graceful drain (idempotent; a second
    signal still just drains — running jobs finish inside the drain
    budget, then are cancelled through the flight recorder)."""

    def _drain(signum, _frame):
        _log.info("[serve] signal %d: draining", signum)
        server.scheduler.request_shutdown(drain=True)

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
