"""On-demand deep profiling: device traces and a host sampling profiler.
The port of the JAX package's ``obs/profiler.py`` (``CaptureBusy`` :68,
``device_trace`` :73, ``HostSampler`` :92, ``default_profile_dir`` :151,
``capture`` :168, ``parse_collapsed`` :295, ``classify_stack`` :311,
``flame_report`` :322, ``format_capture_error`` :359), on
``torch.profiler`` instead of ``jax.profiler``.

* :func:`device_trace` is the whole-job trace (``trace_dir`` /
  ``--trace-dir``): host activity and, on a CUDA device, the device's
  kernels and copies (CUPTI), so the hand-written kernels show under
  their own names (``kmeans_assign_sum``), and the job's spans as
  profiler ranges of the same names (a ``trace_dir`` job is traced);
  written as Chrome trace-event JSON under the directory.
* :func:`capture` drives one bounded capture on a LIVE job or resident
  server (``POST /profile``): a ``torch.profiler`` trace with the CPU and
  (where CUDA is available) CUDA activities, exported as Chrome trace
  JSON under the bundle's ``device/``, plus a **host sampling profiler**
  (a daemon thread snapshotting every Python thread's stack at
  ``host_sample_hz`` via ``sys._current_frames``).  Artifacts land under
  ``profile_dir``: ``profile.json`` (``moxt-profile-v1``),
  ``host_stacks.collapsed`` (flamegraph collapsed-stack format) and
  ``device/``.  CUPTI records device activity for the whole process, so
  kernels launched from other threads (a resident server's workers)
  appear in a capture taken on the HTTP handler's thread; the host
  ranges of every thread are recorded too, so a traced job's spans on a
  worker's thread appear as well.
* ``torch.profiler`` is process-global, so one lock owns it: a whole-job
  trace or one capture's device half.  A capture while a ``trace_dir``
  trace runs records its device half as ``skipped``; a ``trace_dir`` job
  that starts while a capture holds the profiler raises
  :class:`CaptureBusy`.  A second concurrent capture gets
  :class:`CaptureBusy` too (HTTP 409 at ``POST /profile``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

PROFILE_SCHEMA = "moxt-profile-v1"

#: bounded capture: /profile refuses longer requests (a forgotten 1h
#: capture pinning the mutex and the trace buffers is an outage, not a
#: profile)
MAX_CAPTURE_S = 120.0
DEFAULT_CAPTURE_S = 3.0
DEFAULT_HOST_HZ = 50.0

#: the single-capture mutex (process-global)
_capture_lock = threading.Lock()

#: the owner of torch.profiler (process-global, like the profiler): a
#: whole-job trace, or the device half of one capture
_device_lock = threading.Lock()

#: per-process capture ordinal: bundle names carry it so two captures in
#: the same wall-clock second never overwrite each other's artifacts
_capture_seq = 0


class CaptureBusy(RuntimeError):
    """A capture (or a whole-job trace) already holds the profiler."""


def trace_file(log_dir: str) -> str:
    """``<log_dir>/moxt_trace_<utc>_<pid>.json``: one file per job."""
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return os.path.join(log_dir, f"moxt_trace_{stamp}_{os.getpid()}.json")


def _activities(cuda: bool) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str | None, cuda: bool = False):
    """Profile the block with ``torch.profiler`` and write the trace under
    ``log_dir`` (None = no-op).  ``cuda`` adds the CUDA activities.  The
    profiler stops in ``finally`` (a profiler left open after an exception
    would capture the next job too); a failure to start or to export
    raises, and so does a profiler already held by a capture
    (:class:`CaptureBusy`)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import profile

    if not _device_lock.acquire(blocking=False):
        raise CaptureBusy("torch.profiler is already running (a POST "
                          "/profile capture or another job's trace_dir)")
    try:
        os.makedirs(log_dir, exist_ok=True)
        path = trace_file(log_dir)
        with profile(activities=_activities(cuda)) as prof:
            yield path
        prof.export_chrome_trace(path)
    finally:
        _device_lock.release()


class HostSampler:
    """Daemon thread snapshotting all Python thread stacks at ``hz``.

    Aggregates into collapsed-stack form: ``thread;outer;...;leaf`` ->
    sample count, frames spelled ``module.py:function``.  ``hz`` is an
    upper bound — a slow frame walk simply lowers the achieved rate
    (recorded honestly in ``samples``/``duration``)."""

    def __init__(self, hz: float = DEFAULT_HOST_HZ):
        if hz <= 0:
            raise ValueError("host sample rate must be positive")
        self.hz = float(hz)
        self.stacks: dict[str, int] = {}
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-host-sampler")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def sample_once(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the sampler observing itself is noise
            parts: list[str] = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_name}")
                f = f.f_back
            parts.append(names.get(tid, f"thread-{tid}"))
            key = ";".join(reversed(parts))
            self.stacks[key] = self.stacks.get(key, 0) + 1
        self.samples += 1

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:  # a torn frame walk must not kill capture
                pass

    def collapsed(self) -> str:
        """Flamegraph collapsed-stack text: one ``stack count`` line per
        distinct stack, hottest first."""
        return "\n".join(
            f"{stack} {n}" for stack, n in sorted(
                self.stacks.items(), key=lambda kv: (-kv[1], kv[0])))


def default_profile_dir(config) -> str:
    """Where a capture lands when the job/server config has no explicit
    ``--profile-dir``: next to the crash bundles, else next to the
    metrics document, else ``./moxt-profiles``."""
    explicit = getattr(config, "profile_dir", None)
    if explicit:
        return explicit
    crash = getattr(config, "crash_dir", None)
    if crash:
        return os.path.join(crash, "profiles")
    metrics_out = getattr(config, "metrics_out", None)
    if metrics_out:
        return os.path.join(os.path.dirname(os.path.abspath(metrics_out)),
                            "profiles")
    return "moxt-profiles"


def default_profile_dir(config) -> str:
    """Where a capture lands when the job/server config has no explicit
    ``--profile-dir``: next to the crash bundles, else next to the
    metrics document, else ``./moxt-profiles``."""
    explicit = getattr(config, "profile_dir", None)
    if explicit:
        return explicit
    crash = getattr(config, "crash_dir", None)
    if crash:
        return os.path.join(crash, "profiles")
    metrics_out = getattr(config, "metrics_out", None)
    if metrics_out:
        return os.path.join(os.path.dirname(os.path.abspath(metrics_out)),
                            "profiles")
    return "moxt-profiles"


def capture(out_dir: str, duration_s: float = DEFAULT_CAPTURE_S,
            host_sample_hz: float = DEFAULT_HOST_HZ, device: bool = True,
            obs=None, extra_meta: dict | None = None) -> dict:
    """One bounded deep capture; blocks for ``duration_s`` and returns
    the ``profile.json`` document (artifact paths included).

    Raises :class:`CaptureBusy` when another capture holds the mutex and
    ``ValueError`` on an out-of-bounds duration.  A device half that
    fails to start, stop or export is written into the document's
    ``device.error`` (the capture's host half still lands).  ``obs``
    (optional) contributes the live attribution snapshot and the
    ``profile/captures`` counter."""
    if not 0 < duration_s <= MAX_CAPTURE_S:
        raise ValueError(f"capture duration must be in (0, {MAX_CAPTURE_S}]"
                         f" seconds, got {duration_s}")
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profile capture is already running")
    try:
        global _capture_seq
        _capture_seq += 1
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        bundle = os.path.join(
            out_dir,
            f"profile_{stamp}_{os.getpid()}_{_capture_seq:03d}")
        os.makedirs(bundle, exist_ok=True)
        device_doc: dict = {"requested": bool(device)}
        device_dir = os.path.join(bundle, "device")
        prof = None
        owns_device = False
        if device and not _device_lock.acquire(blocking=False):
            device_doc["skipped"] = ("a whole-job trace_dir device "
                                     "trace is already active")
        elif device:
            owns_device = True
            try:
                import torch
                from torch.profiler import _ExperimentalConfig, profile

                # host ranges of every thread: the capture, taken on the
                # HTTP handler's thread, holds the spans of the jobs on
                # the workers' threads (obs/trace.py mirrors them)
                prof = profile(activities=_activities(
                    torch.cuda.is_available()),
                    experimental_config=_ExperimentalConfig(
                        profile_all_threads=True))
                prof.start()
                device_doc["dir"] = device_dir
            except Exception as e:
                prof = None
                device_doc["error"] = f"{type(e).__name__}: {e}"
        sampler = HostSampler(host_sample_hz)
        t0 = time.time()
        sampler.start()
        try:
            time.sleep(duration_s)
        finally:
            sampler.stop()
            try:
                if prof is not None:
                    try:
                        prof.stop()
                        os.makedirs(device_dir, exist_ok=True)
                        path = os.path.join(device_dir, "trace.json")
                        prof.export_chrome_trace(path)
                        device_doc["trace"] = path
                    except Exception as e:
                        device_doc["error"] = f"{type(e).__name__}: {e}"
            finally:
                if owns_device:
                    _device_lock.release()
        collapsed_path = os.path.join(bundle, "host_stacks.collapsed")
        with open(collapsed_path, "w") as f:
            f.write(sampler.collapsed() + "\n")
        doc: dict = {
            "schema": PROFILE_SCHEMA,
            "t_unix_s": round(t0, 3),
            "duration_s": round(time.time() - t0, 3),
            "requested_duration_s": duration_s,
            "host_sample_hz": host_sample_hz,
            "host_samples": sampler.samples,
            "distinct_stacks": len(sampler.stacks),
            "threads": [t.name for t in threading.enumerate()],
            "dir": bundle,
            "host_stacks": collapsed_path,
            "device": device_doc,
        }
        if extra_meta:
            doc["meta"] = extra_meta
        if obs is not None:
            # the resident SERVER's own bundle has no job wall to
            # decompose (the /status and series surfaces skip it too)
            if getattr(obs, "workload", None) != "serve":
                try:
                    from map_oxidize_tpu_torch.obs import attrib

                    doc["attrib"] = attrib.compute(obs)
                except Exception:  # pragma: no cover - defensive
                    pass
            obs.registry.count("profile/captures")
        from map_oxidize_tpu_torch.obs import write_json_atomic

        write_json_atomic(os.path.join(bundle, "profile.json"), doc)
        _log.info("[profile] captured %.1fs (%d host samples) -> %s",
                  doc["duration_s"], sampler.samples, bundle)
        return doc
    finally:
        _capture_lock.release()


# --- collapsed-stack analysis (the `obs flame` report) ---------------------

#: (frame substring, bucket) in PRIORITY order: the first needle found
#: anywhere in a stack wins, so a specific site (the prefetch consumer
#: blocked in queue.get) beats the generic threading.wait it bottoms
#: out in.  The heuristics only need to be good enough to say "this hot
#: stack is the producer / the stall / the dispatch path", matching the
#: ledger's bucket names so the two reports join.
_FRAME_BUCKETS = (
    ("pipeline.py:_produce", "host_produce"),
    ("kmeans.py:_stage", "host_produce"),
    # dataflow finalize compute (the attribution ledger's host_sort
    # bucket): the intra-bucket/host lexsorts, the join probe, and the
    # session gap scan — checked BEFORE the generic spill needles so a
    # sort running inside a bucket drain classifies as the sort, while
    # the drain's file I/O frames still classify spill_io
    ("collect.py:_sorted_host_pairs", "host_sort"),
    ("distributed.py:_sort_kd", "host_sort"),
    ("join.py:probe_join_csr", "host_sort"),
    ("sessionize.py:sessions_from_csr", "host_sort"),
    ("sort.py:write_sorted_records", "host_sort"),
    ("spill.py:", "spill_io"),
    ("disk.py:", "spill_io"),
    (":synchronize", "device_compute"),
    ("compile.py:__call__", "dispatch_gap"),
    ("profiler.py:", "profiler"),
    ("pipeline.py:__iter__", "feed_wait"),
    ("queue.py:get", "feed_wait"),
    ("selectors.py:", "idle"),
    ("socketserver.py:", "idle"),
    ("threading.py:wait", "idle"),
)


def parse_collapsed(text: str) -> list[tuple[list[str], int]]:
    """Parse collapsed-stack lines into ``(frames, count)`` rows."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, n = line.rpartition(" ")
        try:
            count = int(n)
        except ValueError:
            continue
        rows.append((stack.split(";"), count))
    return rows


def classify_stack(frames: list[str]) -> str:
    """Bucket one sampled stack: needles are checked in priority order
    against the whole stack (specific sites outrank the generic waits
    they nest in)."""
    for needle, bucket in _FRAME_BUCKETS:
        for frame in frames:
            if needle in frame:
                return bucket
    return "other"


def flame_report(text: str, attrib_doc: dict | None = None,
                 top: int = 15) -> str:
    """The ``obs flame`` stdout: hottest stacks, hottest leaf frames,
    and the sampled-share vs ledger-attributed-share join."""
    rows = parse_collapsed(text)
    total = sum(n for _f, n in rows) or 1
    lines = [f"host sampling profile: {total} samples, "
             f"{len(rows)} distinct stacks"]
    lines.append("hot stacks:")
    for frames, n in rows[:top]:
        tail = ";".join(frames[-4:])
        lines.append(f"  {100.0 * n / total:5.1f}%  {frames[0]}: ...{tail}")
    leaves: dict[str, int] = {}
    buckets: dict[str, int] = {}
    for frames, n in rows:
        leaves[frames[-1]] = leaves.get(frames[-1], 0) + n
        b = classify_stack(frames)
        buckets[b] = buckets.get(b, 0) + n
    lines.append("hot frames (leaf):")
    for leaf, n in sorted(leaves.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {100.0 * n / total:5.1f}%  {leaf}")
    lines.append("sampled share by attribution bucket"
                 + (" (vs wall-clock ledger):" if attrib_doc else ":"))
    ledger = {}
    if attrib_doc:
        ledger = {name: row["pct"]
                  for name, row in (attrib_doc.get("buckets") or {}).items()}
        ledger["unattributed"] = attrib_doc.get("unattributed_pct")
    for b, n in sorted(buckets.items(), key=lambda kv: -kv[1]):
        line = f"  {b:<16} {100.0 * n / total:5.1f}% sampled"
        lpct = ledger.get(b)
        if lpct is not None:
            line += f"  | {lpct:5.1f}% of wall (ledger)"
        lines.append(line)
    return "\n".join(lines)


def format_capture_error(exc: BaseException) -> dict:
    """Uniform error body for the HTTP layer."""
    return {"error": f"{type(exc).__name__}: {exc}",
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-2000:]}
