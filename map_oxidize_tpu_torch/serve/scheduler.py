"""Job queue + scheduler for the resident job service: a copy of the JAX
package's ``serve/scheduler.py`` (``Scheduler`` :115, ``RESERVED_OVERRIDES``
:66, the live ``/jobs`` rows :577 with the per-job compile overlay :633).

One :class:`Scheduler` owns the whole job lifecycle:

    submit -> queued -> running -> done
                 |          |-> failed       (driver abort; flight-recorded)
                 |          '-> cancelled    (client cancel / deadline;
                 |                            flight-recorded too)
                 '-> cancelled / rejected    (queue cancel; queue_full /
                                              oversized / draining /
                                              input_not_found)

Worker threads multiplex admitted jobs over the EXISTING drivers — each
job runs ``runtime.run_job`` under its own :class:`~map_oxidize_tpu_torch.obs.
Obs` bundle (``Obs.recording`` binds the per-job ObsContext on the
worker thread, and the bind-on-spawn of the obs context carries it into
that job's
prefetch/pool threads), so concurrent jobs keep disjoint metrics docs,
traces, ledger entries, and compile/dispatch accounting.

Admission (:mod:`map_oxidize_tpu_torch.serve.admission`) gates the queue
against the HBM budget: pops SKIP deferred jobs, so a small job is never
head-blocked behind a deferred big one, and every finished job re-wakes
the pop loop — "a queued job runs after HBM frees" is the condition
variable, not a poll.

A reaper thread enforces per-job deadlines (cooperative cancellation
through ``Obs.request_cancel`` — the job aborts at its next phase/feed
boundary and the flight recorder flushes its partial obs) and evicts
idle cached corpora.

Shutdown drains: new submissions reject with ``server_draining``,
running and already-admitted jobs finish (bounded by
``drain_timeout_s``, then they are cancelled), ledgers flush per job as
always, and the workers exit.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from map_oxidize_tpu_torch.config import (
    SERVE_WORKLOADS as WORKLOADS,
    JobConfig,
    ServeConfig,
)
from map_oxidize_tpu_torch.obs import JobCancelled
from map_oxidize_tpu_torch.serve.admission import (
    AdmissionController,
    estimate_hbm_bytes,
)
from map_oxidize_tpu_torch.serve.corpus import CorpusCache
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

JOBS_SCHEMA = "moxt-jobs-v1"

TERMINAL_STATES = frozenset({"done", "failed", "cancelled", "rejected"})

#: JobConfig fields the server owns per job (artifact spool, obs wiring)
#: or does not serve (multi-process jobs have their own launcher) —
#: submission overrides naming one are a malformed request
RESERVED_OVERRIDES = frozenset({
    "input_path", "output_path", "obs_port", "obs_sample_s", "obs_spool",
    "metrics",
    "metrics_out", "crash_dir", "ledger_dir", "progress", "trace_dir",
    "incident_dir", "profile_dir", "calib_dir",
    "dist_coordinator", "dist_num_processes", "dist_process_id",
})

#: serve SLO latency histograms recorded on the SERVER-LIFETIME registry
#: per finished job (cumulative Prometheus buckets at /metrics, summary
#: quantiles beside them): how long submissions queued, how long HBM
#: admission deferred them, and how long they ran
QUEUE_WAIT_MS = "serve/queue_wait_ms"
ADMISSION_WAIT_MS = "serve/admission_wait_ms"
RUN_WALL_MS = "serve/run_wall_ms"


class Job:
    """One submission's full record — queue state, config, admission
    evidence, live obs hookup while running, and the result summary."""

    def __init__(self, job_id: str, workload: str, config: JobConfig,
                 est_hbm_bytes: int, deadline_s: float | None):
        self.id = job_id
        self.workload = workload
        self.config = config
        self.est_hbm_bytes = est_hbm_bytes
        self.state = "queued"
        self.reason: str | None = None
        self.defer_reason: str | None = None
        self.submitted_unix_s = time.time()
        self.started_unix_s: float | None = None
        self.finished_unix_s: float | None = None
        self.deadline_unix_s = (self.submitted_unix_s + deadline_s
                                if deadline_s else None)
        #: the running job's live Obs bundle (set by the driver's on_obs
        #: hook, cleared at finish); cancel requests route through it
        self.obs = None
        self.cancel_requested = False
        self.pending_cancel_reason: str | None = None
        #: first time the HBM budget deferred this job (admission-wait
        #: SLO evidence); None = admitted on first consideration
        self.first_deferred_unix_s: float | None = None
        #: the driver's result object (in-process consumers; never
        #: serialized whole) and its flat metrics summary (the /jobs doc)
        self.result = None
        self.summary: dict = {}


class Scheduler:
    """See the module docstring.  ``runner`` is the job execution seam
    (``(config, workload, on_obs) -> result``); the default runs
    ``runtime.run_job``, tests inject held/slowed runners for
    deterministic admission and cancellation windows."""

    def __init__(self, cfg: ServeConfig, runner=None):
        self.cfg = cfg.validate()
        self._runner = runner if runner is not None else _default_runner
        self._cond = threading.Condition()
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []     # submission order (doc rendering)
        self._queue: list[str] = []     # queued ids, FIFO
        self._running: set[str] = set()
        self._seq = 0
        self._draining = False
        self._stop = False
        self._done_count = 0
        #: the SERVER-LIFETIME metrics registry (the resident server's
        #: own obs bundle attaches it): per-job SLO latency histograms
        #: and the warm-recompile counter land here, where the server's
        #: time-series ring and SLO evaluator watch them.  None for a
        #: bare Scheduler (unit tests) — recording is skipped
        self.server_registry = None
        self.started_at = time.time()
        #: set by request_shutdown (the POST /shutdown endpoint and the
        #: SIGTERM handler) — the server's main loop waits on it
        self.shutdown_requested = threading.Event()
        self.admission = AdmissionController(cfg.hbm_budget_bytes)
        self.corpora = CorpusCache(cfg.idle_evict_s)
        os.makedirs(cfg.spool_dir, exist_ok=True)
        if cfg.ledger_dir == "none":
            self.ledger_dir = None
        else:
            self.ledger_dir = (cfg.ledger_dir
                               or os.path.join(cfg.spool_dir, "ledger"))
        # persistent calibration store shared by every job (and by
        # server restarts — that is the point): each finished job's
        # measured collective/program costs merge atomically into it
        if cfg.calib_dir == "none":
            self.calib_dir = None
        else:
            self.calib_dir = (cfg.calib_dir
                              or os.path.join(cfg.spool_dir, "calib"))
        #: prediction errors (plan/model_error_pct) of the last few
        #: finished jobs — the plan-model-drift SLO rule watches the
        #: MEDIAN so a single noisy micro-job cannot trip it.  Only the
        #: worker thread that finishes a job appends (under the
        #: registry-publish path); bounded so a long-lived server
        #: tracks recent fidelity, not its whole history.
        self._plan_errors: list[float] = []
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"serve-worker-{i}")
            for i in range(cfg.workers)]
        self._reaper = threading.Thread(target=self._reap, daemon=True,
                                        name="serve-reaper")

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        for w in self._workers:
            w.start()
        self._reaper.start()
        _log.info("[serve] scheduler up: %d workers, queue bound %d, "
                  "spool %s", self.cfg.workers, self.cfg.max_queue,
                  self.cfg.spool_dir)

    def request_shutdown(self, drain: bool = True) -> None:
        """Flip to draining (submissions reject from now on) and wake the
        owner's main loop; the actual teardown is :meth:`shutdown`."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if not drain:
            for jid in self.job_ids():
                self.cancel(jid, reason="server_shutdown")
        self.shutdown_requested.set()

    def shutdown(self, drain: bool = True) -> None:
        """Graceful stop: reject new work, let running + admitted jobs
        finish inside ``drain_timeout_s``, cancel the rest, stop the
        workers and the reaper, close cached corpora.  Idempotent."""
        self.request_shutdown(drain)
        deadline = time.monotonic() + (self.cfg.drain_timeout_s if drain
                                       else 1.0)
        with self._cond:
            while ((self._queue or self._running)
                   and time.monotonic() < deadline):
                self._cond.wait(0.1)
            # drain budget exhausted (or non-drain): cancel queued...
            for jid in list(self._queue):
                job = self._jobs[jid]
                self._queue.remove(jid)
                job.state = "cancelled"
                job.reason = "server_shutdown"
                job.finished_unix_s = time.time()
            self._cond.notify_all()
        # ...and running jobs, cooperatively, with a short grace period
        # (snapshot under the lock: workers mutate the set concurrently)
        with self._cond:
            still_running = list(self._running)
        for jid in still_running:
            self.cancel(jid, reason="server_shutdown")
        grace = time.monotonic() + 10.0
        with self._cond:
            while self._running and time.monotonic() < grace:
                self._cond.wait(0.1)
            self._stop = True
            self._cond.notify_all()
        for w in self._workers:
            if w.ident is not None:      # started (joining an unstarted
                w.join(timeout=10)       # thread raises)
        if self._reaper.ident is not None:
            self._reaper.join(timeout=10)
        self.corpora.close_all()    # cache locks itself
        _log.info("[serve] scheduler drained and stopped")

    # --- submission -------------------------------------------------------

    def submit(self, workload: str, input_path: str,
               overrides: dict | None = None, output_path: str = "",
               deadline_s: float | None = None,
               est_hbm_bytes: int = 0) -> Job:
        """Enqueue one job.  Malformed requests (unknown workload,
        reserved/unknown config override, invalid config value) raise
        ``ValueError``; world-state refusals (queue full, oversized
        working set, draining, missing input) return a REJECTED job
        record with the named reason."""
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; "
                             f"serving {', '.join(WORKLOADS)}")
        overrides = dict(overrides or {})
        bad = set(overrides) & RESERVED_OVERRIDES
        if bad:
            raise ValueError(
                f"config overrides {sorted(bad)} are reserved by the "
                "server (artifact spool / obs wiring / multi-process)")
        allowed = {f.name for f in dataclasses.fields(JobConfig)}
        unknown = set(overrides) - allowed
        if unknown:
            raise ValueError(f"unknown config overrides {sorted(unknown)}")
        with self._cond:
            self._seq += 1
            job_id = f"job-{self._seq:04d}"
        job_dir = os.path.join(self.cfg.spool_dir, job_id)
        config = JobConfig(
            input_path=input_path, output_path=output_path, **overrides,
        )
        config = dataclasses.replace(
            config,
            obs_port=-1,                  # ONE telemetry plane: the server's
            obs_sample_s=self.cfg.job_sample_s,
            metrics=False,                # no per-job stdout metrics line
            metrics_out=os.path.join(job_dir, "metrics.json"),
            crash_dir=os.path.join(job_dir, "crash"),
            incident_dir=os.path.join(job_dir, "incidents"),
            profile_dir=os.path.join(job_dir, "profiles"),
            ledger_dir=self.ledger_dir,
            calib_dir=self.calib_dir,
            progress=False,
        ).validate()                      # ValueError -> caller (HTTP 400)
        est = est_hbm_bytes or estimate_hbm_bytes(config, workload)
        job = Job(job_id, workload, config, est, deadline_s)
        # corpus open/validation OUTSIDE the scheduler lock (the cache
        # locks itself): a stalled filesystem on one bad submit must not
        # freeze the pop loop, the reaper, and every /jobs scrape
        input_err: str | None = None
        try:
            self.corpora.open(input_path)
        except OSError as e:
            input_err = f"input_not_found: {e}"
        with self._cond:
            self._jobs[job.id] = job
            self._order.append(job.id)
            if self._draining:
                return self._reject_locked(job, "server_draining")
            if input_err is not None:
                return self._reject_locked(job, input_err)
            decision, reason = self.admission.decide(est)
            if decision == "reject":
                return self._reject_locked(job, reason)
            if len(self._queue) >= self.cfg.max_queue:
                return self._reject_locked(
                    job, f"queue_full: {len(self._queue)} queued >= "
                         f"bound {self.cfg.max_queue}")
            self._queue.append(job.id)
            self._cond.notify_all()
        _log.info("[serve] %s queued: %s %s (est %.1f MB HBM)", job.id,
                  workload, input_path, est / (1 << 20))
        return job

    def _reject_locked(self, job: Job, reason: str) -> Job:
        job.state = "rejected"
        job.reason = reason
        job.finished_unix_s = time.time()
        # rejections are terminal too: a client retry storm against a
        # draining/full server must not grow the history unboundedly
        self._prune_locked()
        _log.info("[serve] %s rejected: %s", job.id, reason)
        return job

    # --- cancellation -----------------------------------------------------

    def cancel(self, job_id: str,
               reason: str = "cancelled_by_client") -> Job | None:
        """Cancel a queued job immediately, or request cooperative
        cancellation of a running one (it aborts at its next phase/feed
        boundary, through the flight recorder).  Terminal jobs are left
        alone.  Returns the job record, or None for an unknown id."""
        obs = None
        with self._cond:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job.state == "queued":
                self._queue.remove(job.id)
                job.state = "cancelled"
                job.reason = reason
                job.finished_unix_s = time.time()
                self._cond.notify_all()
            elif job.state == "running":
                job.cancel_requested = True
                job.pending_cancel_reason = reason
                obs = job.obs
        if obs is not None:
            obs.request_cancel(reason)
        return job

    def wait(self, job_id: str, timeout: float | None = None) -> Job:
        """Block until the job reaches a terminal state.  Holds the Job
        record (state is updated in place), so a concurrent history
        prune cannot strand the waiter; an id that was never submitted
        (or already pruned) raises a named ``KeyError``."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cond:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"unknown (or history-pruned) job "
                               f"{job_id!r}")
            while True:
                if job.state in TERMINAL_STATES:
                    return job
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{job_id} still {job.state} after {timeout}s")
                self._cond.wait(0.1)

    def job_ids(self) -> list[str]:
        with self._cond:
            return list(self._order)

    # --- workers ----------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                job = None
                while True:
                    if self._stop:
                        return
                    job = self._pop_admissible_locked()
                    if job is not None:
                        break
                    # timed wait: the measured-live half of the admission
                    # decision can change without a notify
                    self._cond.wait(0.1)
                job.state = "running"
                job.started_unix_s = time.time()
                self._running.add(job.id)
                self.admission.reserve(job.est_hbm_bytes)
            self._run(job)

    def _pop_admissible_locked(self) -> Job | None:
        """First queued job the HBM budget admits.  Deferred jobs are
        SKIPPED (reason recorded on the job), so a small job behind a
        deferred big one still runs — FIFO among admissible jobs."""
        for jid in list(self._queue):
            job = self._jobs[jid]
            decision, reason = self.admission.decide(job.est_hbm_bytes)
            if decision == "admit":
                self._queue.remove(jid)
                job.defer_reason = None
                return job
            if job.first_deferred_unix_s is None:
                job.first_deferred_unix_s = time.time()
            job.defer_reason = reason     # "defer" (reject happened at
            #                               submit; a later budget shrink
            #                               keeps the job waiting, named)
        return None

    def _run(self, job: Job) -> None:
        def _hook(obs):
            with self._cond:
                job.obs = obs
                if job.cancel_requested:   # cancelled between pop and run
                    obs.request_cancel(job.pending_cancel_reason
                                       or "cancelled")

        _log.info("[serve] %s running: %s", job.id, job.workload)
        state, reason, result = "done", None, None
        try:
            try:
                # the job's artifact spool dir, created HERE on the
                # worker (never under the scheduler lock; rejected jobs
                # never get one) — metrics_out's atomic writer needs the
                # parent to exist
                os.makedirs(os.path.dirname(job.config.metrics_out),
                            exist_ok=True)
                result = self._runner(job.config, job.workload, _hook)
            except JobCancelled as e:
                state, reason = "cancelled", str(e)
            except Exception as e:  # noqa: BLE001 — a job abort (flight-
                # recorded by the driver) must not take the worker down
                state, reason = "failed", f"{type(e).__name__}: {e}"
            except BaseException as e:  # even a SystemExit from a job
                # body, or a KeyboardInterrupt re-raised by the pipeline
                # (kill-resume contract), must not kill the worker slot:
                # the job fails (flight-recorded), the server keeps
                # serving the other slots and the queue
                state, reason = "failed", f"{type(e).__name__}: {e}"
                _log.error("[serve] %s raised %s through the worker; "
                           "slot kept alive", job.id, type(e).__name__)
        finally:
            with self._cond:
                job.obs = None
                job.state = state
                job.reason = reason
                job.result = result
                job.summary = dict(getattr(result, "metrics", None) or {})
                job.finished_unix_s = time.time()
                self._running.discard(job.id)
                self.admission.release(job.est_hbm_bytes)
                self.corpora.touch(job.config.input_path)
                warm_before = self._done_count
                if state == "done":
                    self._done_count += 1
                self._prune_locked()
                self._cond.notify_all()
            # SLO latency metrics OUTSIDE the scheduler lock (the
            # registry locks itself; nothing here may serialize the
            # pop loop or /jobs scrapes)
            self._record_slo_metrics(job, state, warm_before)
        _log.info("[serve] %s %s%s", job.id, state,
                  f": {reason}" if reason else "")

    def _record_slo_metrics(self, job: Job, state: str,
                            warm_before: int) -> None:
        """Per-job serve SLO evidence into the SERVER-LIFETIME registry:
        queue-wait / admission-wait / run-wall histograms (cumulative
        Prometheus buckets at /metrics) plus per-state job counters and
        the warm-recompile counter — compile deltas on any job after the
        first completed one, the signal the ``warm-serve-recompile``
        default SLO rule watches (the flat-program-count invariant) — and
        the port's ``kernels/<name>/launches`` gauges (each hand kernel's
        launches in this process)."""
        reg = self.server_registry
        if reg is None:
            return
        from map_oxidize_tpu_torch.obs.metrics import LATENCY_BUCKETS_MS

        reg.count("serve/jobs_total", 1)
        reg.count(f"serve/jobs_{state}", 1)
        if job.started_unix_s is not None:
            reg.observe(QUEUE_WAIT_MS,
                        (job.started_unix_s - job.submitted_unix_s) * 1e3,
                        buckets=LATENCY_BUCKETS_MS)
            reg.observe(ADMISSION_WAIT_MS,
                        ((job.started_unix_s - job.first_deferred_unix_s)
                         * 1e3 if job.first_deferred_unix_s else 0.0),
                        buckets=LATENCY_BUCKETS_MS)
            if job.finished_unix_s is not None:
                reg.observe(RUN_WALL_MS,
                            (job.finished_unix_s - job.started_unix_s)
                            * 1e3, buckets=LATENCY_BUCKETS_MS)
        if state == "done" and warm_before >= 1:
            compiles = job.summary.get("compile/total_compiles") or 0
            if compiles > 0:
                reg.count("serve/warm_compiles", compiles)
        # the hand kernels' launches in this process so far: the evidence
        # that served jobs ran them (the wrappers' own counts)
        from map_oxidize_tpu_torch.ops import kernel_launches

        for name, n in kernel_launches().items():
            reg.set(f"kernels/{name}/launches", n)
        # plan observatory: fold this job's predicted-vs-actual wall
        # error into the server-lifetime drift gauge.  Publish the
        # MEDIAN of the last few finished jobs so the plan-model-drift
        # SLO rule sees sustained staleness, not one noisy micro-job; a
        # cold server (no warm-curve predictions yet) publishes nothing
        # and the rule stays silent by construction.
        if state == "done":
            err = job.summary.get("plan/model_error_pct")
            if isinstance(err, (int, float)):
                self._plan_errors.append(float(err))
                del self._plan_errors[:-8]
                ranked = sorted(self._plan_errors)
                reg.set("plan/model_error_pct",
                        round(ranked[len(ranked) // 2], 2))

    def _prune_locked(self) -> None:
        """Bound the job history: a resident process must not grow RSS
        with every job it ever served.  Oldest TERMINAL jobs past the
        retention cap are dropped whole (their artifacts stay on disk in
        the spool; /jobs simply stops listing them)."""
        cap = self.cfg.max_history
        terminal = [jid for jid in self._order
                    if self._jobs[jid].state in TERMINAL_STATES]
        for jid in terminal[:max(len(terminal) - cap, 0)]:
            self._order.remove(jid)
            del self._jobs[jid]

    # --- reaper: deadlines + idle corpus eviction -------------------------

    def _reap(self) -> None:
        while not self._stop:
            now = time.time()
            expired = []
            with self._cond:
                for jid in list(self._queue) + list(self._running):
                    job = self._jobs[jid]
                    if (job.deadline_unix_s is not None
                            and now >= job.deadline_unix_s
                            and not job.cancel_requested):
                        expired.append(jid)
            # eviction closes files (blocking I/O) and the cache locks
            # itself — never under the scheduler lock
            self.corpora.evict_idle()
            for jid in expired:
                self.cancel(jid, reason="deadline_exceeded")
            time.sleep(0.05)

    # --- documents (the /jobs endpoints) ----------------------------------

    def health_doc(self) -> dict:
        """The job-plane slice of ``GET /healthz``: counts only, no
        per-job row rendering — cheap enough for a fleet collector or
        router to poll every tick."""
        with self._cond:
            return {
                "running": len(self._running),
                "queued": len(self._queue),
                "queue_depth": len(self._queue),
                "max_queue": self.cfg.max_queue,
                "workers": self.cfg.workers,
                "draining": self._draining,
            }

    def jobs_doc(self) -> dict:
        now = time.time()
        with self._cond:
            rows = [self._row_locked(self._jobs[jid], now)
                    for jid in reversed(self._order)]
            counts: dict[str, int] = {}
            for jid in self._order:
                s = self._jobs[jid].state
                counts[s] = counts.get(s, 0) + 1
            return {
                "schema": JOBS_SCHEMA,
                "t_unix_s": round(now, 3),
                "uptime_s": round(now - self.started_at, 3),
                "draining": self._draining,
                "workers": self.cfg.workers,
                "queue": {"depth": len(self._queue),
                          "max": self.cfg.max_queue},
                "hbm": self.admission.doc(),
                "corpora": self.corpora.doc(),
                "counts": counts,
                "jobs": rows,
            }

    def job_doc(self, job_id: str) -> dict | None:
        now = time.time()
        with self._cond:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            return self._row_locked(job, now, full=True)

    def job_row(self, job: Job) -> dict:
        """Render a HELD Job record — the submit/cancel HTTP responses
        use this instead of a by-id lookup, which a concurrent history
        prune (e.g. a rejection storm with a small ``max_history``)
        could turn into None mid-request."""
        with self._cond:
            return self._row_locked(job, time.time(), full=True)

    def _row_locked(self, job: Job, now: float, full: bool = False) -> dict:
        row = {
            "id": job.id,
            "workload": job.workload,
            "state": job.state,
            "reason": job.reason or job.defer_reason,
            "input": job.config.input_path,
            "est_hbm_bytes": job.est_hbm_bytes,
            "submitted_unix_s": round(job.submitted_unix_s, 3),
        }
        if job.deadline_unix_s is not None:
            row["deadline_unix_s"] = round(job.deadline_unix_s, 3)
        if job.started_unix_s is not None:
            row["started_unix_s"] = round(job.started_unix_s, 3)
            row["queue_wait_s"] = round(
                job.started_unix_s - job.submitted_unix_s, 3)
        if job.finished_unix_s is not None:
            row["finished_unix_s"] = round(job.finished_unix_s, 3)
            if job.started_unix_s is not None:
                row["duration_s"] = round(
                    job.finished_unix_s - job.started_unix_s, 3)
        if job.state == "running" and job.obs is not None:
            obs = job.obs
            elapsed = max(now - (job.started_unix_s or now), 1e-9)
            row["elapsed_s"] = round(elapsed, 3)
            row["phase"] = obs.current_phase
            hb = obs.heartbeat
            if hb is not None:
                row["phase"] = hb.phase or row["phase"]
                row["rows"] = hb.rows
                row["rows_per_sec"] = round(hb.rows / elapsed, 1)
                if hb.where is not None:
                    # the attribution ledger's live one-token answer
                    # (e.g. "compute 61%"), refreshed per series tick
                    row["where"] = hb.where
            # live per-job compile evidence (the overlay: activity routed
            # to THIS job, disjoint from concurrent ones)
            from map_oxidize_tpu_torch.obs.compile import job_overlay_delta

            delta = job_overlay_delta(obs)
            row["compiles"] = sum(d["compiles"] for d in delta.values())
            row["dispatches"] = sum(d["dispatches"]
                                    for d in delta.values())
        if job.state == "done":
            row["records_in"] = job.summary.get("records_in")
            row["compiles"] = job.summary.get("compile/total_compiles")
        if job.state in TERMINAL_STATES and job.state != "rejected":
            row["artifacts"] = {
                "metrics_out": job.config.metrics_out,
                "output": job.config.output_path or None,
                "crash_dir": job.config.crash_dir,
            }
        if full and job.summary:
            row["metrics"] = dict(job.summary)
        return row


def _default_runner(config: JobConfig, workload: str, on_obs):
    from map_oxidize_tpu_torch.runtime import run_job

    return run_job(config, workload, on_obs=on_obs)
