"""Reading a ``torch.profiler`` capture of the measured window.

The device events (kernels, copies, memsets) come from ``prof.events()``
with their start and end in microseconds from the start of the capture;
the benchmark's own spans (``record_function`` ranges named
``portbench/...``) share that clock.  From them: the device's busy time
(the union of its events) inside the window, the time per kernel, the
device operations that took most time, and the longest idle gaps, each
labelled by the benchmark's span and the port's phase that were open.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def union(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class Trace:
    """The window's device events and spans, times in microseconds."""

    window: tuple[float, float]
    #: (start, end, name) of every device event inside the window
    device: list = field(default_factory=list)
    #: (start, end) of each job
    jobs: list = field(default_factory=list)
    #: (start, end, label) of the port's spans, mapped to this clock
    spans: list = field(default_factory=list)

    @classmethod
    def from_profile(cls, prof, port_spans=()) -> "Trace":
        """From a finished ``torch.profiler.profile``; ``port_spans`` maps
        each job's index to ``(offset_us, chrome_events)``: the port's
        trace of that job and where its clock starts relative to the job's
        ``portbench/job`` range."""
        window, jobs, dev, host_names = None, [], [], set()
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if str(e.device_type).endswith("CUDA"):
                dev.append((a, b, e.name))
                continue
            host_names.add(e.name)
            if e.name == "portbench/window":
                window = (a, b)
            elif e.name == "portbench/job":
                jobs.append((a, b))
        # a host range (record_function) is mirrored on the device's
        # timeline as an annotation: no device work
        dev = [x for x in dev if x[2] not in host_names]
        if window is None:
            raise RuntimeError("the capture has no portbench/window range")
        jobs.sort()
        lo, hi = window
        spans = []
        for i, (offset, events) in dict(port_spans).items():
            if i >= len(jobs):
                continue
            base = jobs[i][0] + offset
            for ev in events:
                if ev.get("ph") == "X" and ev.get("tid") == 0:
                    s = base + ev["ts"]
                    spans.append((s, s + ev["dur"], ev["name"]))
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
               if b > lo and a < hi]
        return cls(window=window, device=dev, jobs=jobs, spans=spans)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union((a, b) for a, b, _ in self.device) / 1e6

    def kernel_seconds(self, kernel: str) -> float:
        """Device seconds of the kernels in the namespace ``kernel``."""
        tag = f"{kernel}::"
        return sum(b - a for a, b, n in self.device if tag in n) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:160], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def _label(self, t: float) -> str:
        job = any(a <= t <= b for a, b in self.jobs)
        parts = ["job" if job else "between jobs"]
        inner = [(b - a, name) for a, b, name in self.spans if a <= t <= b]
        phases = [x for x in inner if x[1].startswith("phase/")]
        if phases:
            parts.append(min(phases)[1])
        others = [x for x in inner if not x[1].startswith("phase/")]
        if others:
            parts.append(min(others)[1])
        return " > ".join(parts)

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches of the window with no device event,
        each as ``[label, seconds]``."""
        gaps, end = [], self.window[0]
        for a, b in sorted((a, b) for a, b, _ in self.device):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:n]]
