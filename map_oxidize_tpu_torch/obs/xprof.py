"""Program observatory: the cost/roofline join, the report rendering and
the live device sampler.  The port of the JAX package's ``obs/xprof.py``
(``device_peaks`` :56, ``job_report`` :87, ``flatten_report`` :148,
``render_report`` :189, ``DeviceSampler`` :241).

* :func:`job_report` joins a job's launch-ledger delta
  (:meth:`~map_oxidize_tpu_torch.obs.compile.CompileLedger.job_delta`)
  with the card's peaks into per-program rows: achieved FLOP/s and bytes/s
  over the estimated device time (the sampled device waits when there are
  samples, else the dispatch walls), MFU and bandwidth share against the
  peaks, and a memory- or compute-bound class from the arithmetic
  intensity against the machine balance;
* :class:`DeviceSampler` is one low-rate daemon thread per job: the live
  device-memory watermark (``hbm/live_bytes_device<i>``) and the stall
  detector (one ``[stalled]`` line naming the open spans when no chunk
  completes within a multiple of the median inter-chunk interval).
"""

from __future__ import annotations

import os
import threading
import time

from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: measured peaks by ``torch.cuda.get_device_name()``: the sustained bf16
#: matmul rate (``torch.matmul`` at 8192^3) and the device-to-device copy
#: rate, from ``chip_smoke.py`` phase 12 on an H100 80GB HBM3 at a 700 W
#: power limit (PERF.md section 5).  Any other card, and the CPU, has no
#: entry: MFU is omitted there.
MEASURED_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 8.02769e14, "membw": 2.99651e12},
}

#: machine-balance fallback (FLOPs per byte) for the bound class when no
#: peak pair is known: the H100 row's ratio, rounded
DEFAULT_BALANCE = 268.0


def device_peaks() -> dict:
    """The peak rates MFU is quoted against.  ``MOXT_PEAK_FLOPS`` /
    ``MOXT_PEAK_MEMBW`` override per field; what they leave unset comes
    from :data:`MEASURED_PEAKS` for the card this process has already
    initialised (never initialising CUDA), and stays None otherwise."""
    peaks = {"flops": None, "membw": None, "source": "none"}
    try:
        import torch

        if torch.cuda.is_initialized():
            row = MEASURED_PEAKS.get(torch.cuda.get_device_name(
                torch.cuda.current_device()))
            if row is not None:
                peaks.update(row, source="measured-default")
    except Exception:
        pass
    env_used = False
    for env, key in (("MOXT_PEAK_FLOPS", "flops"),
                     ("MOXT_PEAK_MEMBW", "membw")):
        v = os.environ.get(env)
        if v:
            try:
                peaks[key] = float(v)
                env_used = True
            except ValueError:
                pass
    if env_used:
        peaks["source"] = ("env" if peaks["source"] == "none"
                           else f"env+{peaks['source']}")
    return peaks


def job_report(delta: dict) -> dict:
    """Join one job's ledger delta with the peaks into the per-program
    rows of the metrics document (``metrics.json["xprof"]``)."""
    peaks = device_peaks()
    balance = (peaks["flops"] / peaks["membw"]
               if peaks["flops"] and peaks["membw"] else DEFAULT_BALANCE)
    programs = {}
    for name, d in sorted(delta.items()):
        row = dict(d)
        n = d["dispatches"]
        flops = d.get("flops_per_dispatch")
        bytes_ = d.get("bytes_per_dispatch")
        # device time: mean sampled wait x dispatches when sampled, else
        # the summed dispatch walls (an upper bound)
        dev_s = None
        if d["device_samples"] > 0 and d["sampled_device_ms"] > 0:
            dev_s = (d["sampled_device_ms"] / d["device_samples"]) * n / 1e3
            row["device_time_source"] = "sampled_ready_wait"
        elif d["dispatch_ms"] > 0:
            dev_s = d["dispatch_ms"] / 1e3
            row["device_time_source"] = "dispatch_wall"
        row["device_s_est"] = round(dev_s, 6) if dev_s else None
        ch = d.get("logical_chunks") or 0
        if ch and d["dispatch_ms"] > 0:
            row["chunks_per_dispatch"] = round(
                ch / max(n - d["compiles"], 1), 2)
            row["dispatch_gap_per_chunk_ms"] = round(
                d["dispatch_ms"] / ch, 4)
        if n and flops and dev_s:
            row["achieved_flops_per_s"] = round(flops * n / dev_s, 1)
            if peaks["flops"]:
                row["mfu_pct"] = round(
                    100.0 * flops * n / dev_s / peaks["flops"], 3)
        if n and bytes_ and dev_s:
            row["achieved_bytes_per_s"] = round(bytes_ * n / dev_s, 1)
            if peaks["membw"]:
                row["membw_pct"] = round(
                    100.0 * bytes_ * n / dev_s / peaks["membw"], 3)
        if flops and bytes_:
            intensity = flops / bytes_
            row["intensity_flops_per_byte"] = round(intensity, 4)
            row["bound"] = "compute" if intensity >= balance else "memory"
        programs[name] = row
    return {
        "programs": programs,
        "peaks": peaks,
        "balance_flops_per_byte": round(balance, 2),
        "total_compiles": sum(d["compiles"] for d in delta.values()),
        "total_compile_ms": round(
            sum(d["compile_ms"] for d in delta.values()), 3),
        "total_dispatches": sum(d["dispatches"] for d in delta.values()),
    }


def flatten_report(report: dict) -> dict:
    """The scalar projection of :func:`job_report` for the flat metrics
    summary (``JobResult.metrics``)."""
    out = {
        "compile/total_compiles": report["total_compiles"],
        "compile/total_ms": report["total_compile_ms"],
    }
    for name, row in report["programs"].items():
        out[f"compile/{name}/compiles"] = row["compiles"]
        out[f"compile/{name}/shape_sets"] = row["shape_sets"]
        if row["recompile_causes"]:
            out[f"compile/{name}/recompile_cause"] = \
                row["recompile_causes"][-1]
        out[f"xprof/{name}/dispatches"] = row["dispatches"]
        for k in ("mfu_pct", "membw_pct", "bound"):
            if row.get(k) is not None:
                out[f"xprof/{name}/{k}"] = row[k]
        if row.get("dispatch_gap_per_chunk_ms") is not None:
            out[f"xprof/{name}/logical_chunks"] = row["logical_chunks"]
            out[f"xprof/{name}/dispatch_gap_per_chunk_ms"] = \
                row["dispatch_gap_per_chunk_ms"]
    return out


def _fmt_rate(v, unit):
    if v is None:
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if v >= scale:
            return f"{v / scale:.2f} {suffix}{unit}"
    return f"{v:.1f} {unit}"


def render_report(report: dict, histograms: dict | None = None) -> str:
    """Human-readable observatory report: the compile table, the
    cost/utilization table and the dispatch-gap histogram summary."""
    lines = ["program observatory"]
    peaks = report.get("peaks", {})
    lines.append(
        f"  peaks: flops={_fmt_rate(peaks.get('flops'), 'FLOP/s')} "
        f"membw={_fmt_rate(peaks.get('membw'), 'B/s')} "
        f"({peaks.get('source', '?')}); balance "
        f"{report.get('balance_flops_per_byte')} FLOP/byte")
    progs = report.get("programs", {})
    if not progs:
        lines.append("  (no observed programs ran in this job)")
        return "\n".join(lines)
    lines.append(
        f"  {report['total_compiles']} compiles "
        f"({report['total_compile_ms']:.1f} ms) across {len(progs)} "
        f"programs, {report['total_dispatches']} dispatches")
    lines.append("compiles:")
    lines.append(f"  {'program':<28} {'n':>3} {'ms':>9} {'shapes':>6}  cause")
    for name, r in progs.items():
        cause = ", ".join(r["recompile_causes"]) or "-"
        lines.append(f"  {name:<28} {r['compiles']:>3} "
                     f"{r['compile_ms']:>9.1f} {r['shape_sets']:>6}  {cause}")
    lines.append("cost / utilization:")
    lines.append(f"  {'program':<28} {'disp':>5} {'flops/disp':>11} "
                 f"{'bytes/disp':>11} {'achieved':>12} {'MFU%':>6} "
                 f"{'bw%':>6}  bound")
    for name, r in progs.items():
        lines.append(
            f"  {name:<28} {r['dispatches']:>5} "
            f"{_fmt_rate(r.get('flops_per_dispatch'), ''):>11} "
            f"{_fmt_rate(r.get('bytes_per_dispatch'), ''):>11} "
            f"{_fmt_rate(r.get('achieved_flops_per_s'), 'F/s'):>12} "
            f"{r.get('mfu_pct', '-'):>6} {r.get('membw_pct', '-'):>6}  "
            f"{r.get('bound', '-')}")
    for h in ("device/dispatch_gap_ms", "device/dispatch_gap_per_chunk_ms",
              "device/compute_ms"):
        s = (histograms or {}).get(h)
        if s:
            lines.append(f"{h}: n={s.get('count')} p50={s.get('p50')} "
                         f"p95={s.get('p95')} max={s.get('max')} "
                         f"mean={s.get('mean')}")
    return "\n".join(lines)


class DeviceSampler:
    """Low-rate daemon thread: live device-memory watermarks and the stall
    detector.  Chunk progress is read from the job's own registry, so the
    detector needs no hooks in the drivers; a warning fires once per
    episode (a completing chunk re-arms it)."""

    #: registry series whose growth means "a chunk completed"
    PROGRESS_HISTS = ("feed_block_ms", "device/dispatch_gap_ms")
    PROGRESS_COUNTERS = ("engine/flushes", "pipeline/chunks")

    def __init__(self, obs, interval_s: float = 0.0,
                 stall_factor: float = 0.0):
        self.obs = obs
        self.interval_s = interval_s if interval_s > 0 else 0.5
        self.stall_factor = stall_factor
        self.sample_hbm = interval_s > 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-device-sampler")
        self._intervals: list[float] = []
        self._last_signal = 0
        self._last_change = time.monotonic()
        self._warned = False
        self.stall_warnings = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self.sample_hbm:  # short jobs still record one sample
            self.sample_once()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.sample_hbm:
                self.sample_once()
            if self.stall_factor > 0:
                self.check_stall()

    def sample_once(self) -> None:
        """One live-bytes reading per CUDA device (the caching allocator's
        ``allocated_bytes.all.current``).  A no-op until the job itself
        has initialised CUDA (the sampler never does)."""
        import torch

        if not torch.cuda.is_initialized():
            return
        best = None
        for i in range(torch.cuda.device_count()):
            in_use = torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current")
            if in_use is None:
                continue
            self.obs.registry.gauge_max(f"hbm/live_bytes_device{i}",
                                        int(in_use))
            best = max(best or 0, int(in_use))
        if best is not None and self.obs.heartbeat is not None:
            self.obs.heartbeat.hbm_bytes = best

    def _progress_signal(self) -> int:
        reg = self.obs.registry
        with reg._lock:
            n = sum(reg.histograms[h].count for h in self.PROGRESS_HISTS
                    if h in reg.histograms)
            n += sum(int(reg.counters.get(c, 0))
                     for c in self.PROGRESS_COUNTERS)
        return n

    def check_stall(self, now: float | None = None) -> bool:
        """One detector tick (public for fake-clock tests); True when a
        stall warning was emitted this tick."""
        now = time.monotonic() if now is None else now
        sig = self._progress_signal()
        if sig != self._last_signal:
            if self._last_signal:
                self._intervals.append(now - self._last_change)
                if len(self._intervals) > 64:
                    del self._intervals[0]
            self._last_signal = sig
            self._last_change = now
            self._warned = False
            return False
        if self._warned or len(self._intervals) < 3:
            return False
        med = sorted(self._intervals)[len(self._intervals) // 2]
        elapsed = now - self._last_change
        if med <= 0 or elapsed < self.stall_factor * med:
            return False
        self._warned = True
        self.stall_warnings += 1
        tracer = self.obs.tracer
        spans = []
        if tracer.enabled:
            with tracer._lock:
                for _tid, stack in tracer._stacks:
                    if stack:
                        spans.append(" > ".join(s.name for s in stack))
        open_s = "; ".join(spans) if spans else "(no trace: run with " \
                                                "--trace-out for span names)"
        line = (f"[stalled] no chunk completed in {elapsed:.1f}s "
                f"(median {med:.2f}s, factor {self.stall_factor:g}); "
                f"open spans: {open_s}")
        hb = self.obs.heartbeat
        if hb is not None and not hb.silent:
            hb._emit(line)
        else:
            # no heartbeat, or a silent tracking-only one (the live
            # plane's /status feed): the warning must still hit the log
            _log.warning("%s", line)
        self.obs.registry.count("heartbeat/stalls")
        return True
