"""Nested, thread-safe spans with Chrome trace-event export: the port of
the JAX package's ``obs/trace.py`` (``Tracer`` :104, ``Span`` :57,
``NULL_SPAN`` :54), which imports no JAX and is copied here because the
port imports nothing of that package.

Event model: a span is one timed region (``ph="X"`` complete event in
Chrome trace-event terms) with free-form scalar attributes (rows, bytes,
chunk sequence).  Spans nest per thread — each thread keeps its own
open-span stack, so the driver loop, the prefetch and staging producer
threads (:mod:`map_oxidize_tpu_torch.runtime.pipeline`) and the map
executor's workers interleave without sharing a stack — and the flat
event list records the parent depth.  The Chrome export compacts thread
idents to small ``tid`` numbers (0 = the first thread seen, the driver).

Disabled tracers hand out one shared no-op span object, so the per-site
cost of an un-traced run is a single attribute check.

While a ``torch.profiler`` capture is recording (the benchmark's, a
``trace_dir`` whole-job trace, a ``POST /profile`` capture), every span
also opens a profiler range of the same name on its own thread, so the
capture holds the port's spans on the profiler's own clock, beside the
device's kernels and copies.  The check is one flag of
``torch.autograd.profiler``, read only once this process has imported
torch; this module never imports it.  Without a capture an enabled
tracer pays that one check per span.

The pipeline's producer/consumer handoff spans carry ``seq=<n>`` tags in
their args, pairing each ``<name>/produce`` with the consumer's
``<name>/feed_wait`` of the same item.

Open the exported file at ``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

#: ``torch.autograd.profiler`` once this process has imported torch (read
#: from ``sys.modules``, never imported here)
_autograd_profiler = None


def _capture_running() -> bool:
    """True while a ``torch.profiler`` capture records in this process."""
    global _autograd_profiler
    prof = _autograd_profiler
    if prof is None:
        prof = _autograd_profiler = sys.modules.get(
            "torch.autograd.profiler")
        if prof is None:
            return False
    return prof._is_profiler_enabled


def _open_range(name: str):
    """A profiler range ``name`` opened now on this thread (closed by
    :func:`_close_range`), or None when the profiler refuses it.  The
    range is torch's C++ ``_RecordFunctionFast``: the Python
    ``record_function`` runs a profiled op at each end, which under a
    capture stretches the range tens of microseconds past the span."""
    try:
        rf = sys.modules["torch"]._C._profiler._RecordFunctionFast(name)
        rf.__enter__()
        return rf
    except Exception:  # profiling is evidence: it never fails a job
        return None


def _close_range(rf) -> None:
    try:
        rf.__exit__(None, None, None)
    except Exception:
        pass


class _NullSpan:
    """Shared do-nothing span for disabled tracers (and a safe default for
    engines whose driver never attached an ``Obs``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One open timed region.  Use as a context manager; the end time is
    recorded in ``__exit__`` even when the body raises, and an exception
    is annotated on the event (``error`` attribute) rather than losing
    the span."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_t1", "_depth",
                 "_done", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._done = False
        #: the mirrored profiler range while a capture records
        self._range = None

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes while the span is open."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        # the mirrored range encloses the span: its own cost stays out of
        # the span's time
        if _capture_running():
            self._range = _open_range(self.name)
        self._t0 = self._tracer._clock()
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._t1 = self._tracer._clock()
        if self._range is not None:
            _close_range(self._range)
            self._range = None
        stack = self._tracer._stack()
        # exception safety: pop through to this span even if a child span
        # leaked (its __exit__ never ran because of a lower-level crash)
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if self._done:
            # close_open_spans already exported this span (a crash on
            # another thread force-closed it); don't record it twice
            return False
        self._done = True
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer._record(self.name, self._t0, t1, self._depth,
                             self.attrs)
        return False


class Tracer:
    """Collects span/instant events; exports Chrome trace JSON or JSONL.

    Thread-safe: the event list is guarded by a lock, the open-span stack
    is thread-local.  Timestamps are microseconds since tracer creation
    (``perf_counter``-based, so durations are monotonic and immune to
    wall-clock steps).
    """

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._epoch = clock()
        #: wall-clock instant of the epoch — the cross-process alignment
        #: anchor (perf_counter epochs are per-process and incomparable;
        #: the shard merger offsets each shard by its wall start)
        self.wall_start = time.time()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        #: every thread's open-span stack, for close_open_spans (the
        #: thread-local view alone can only see the CURRENT thread's)
        self._stacks: list[list] = []
        self._pid = os.getpid()

    # --- recording --------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                # remember the owning thread: close_open_spans runs on
                # the CRASHING thread but must attribute each leaked
                # span to the thread that opened it
                self._stacks.append((threading.get_ident(), stack))
        return stack

    def close_open_spans(self, error: str | None = None) -> int:
        """Record every still-open span (any thread) as ended NOW, tagged
        ``unfinished`` (plus ``error`` when given), under its OWNING
        thread's tid.  The flight recorder calls this when a job dies
        mid-phase so the exported trace is well-formed — Perfetto renders
        a truncated timeline instead of losing the phases the crash
        interrupted.  Spans closed here are marked done, so a thread
        that later unwinds its ``with`` block does not record a
        duplicate."""
        if not self.enabled:
            return 0
        now = self._clock()
        with self._lock:
            stacks = [(tid, list(s)) for tid, s in self._stacks]
            for _tid, s in self._stacks:
                s.clear()
        closed = 0
        for tid, stack in stacks:
            for depth, span in enumerate(stack):
                span._done = True
                attrs = dict(span.attrs, unfinished=True)
                if error is not None:
                    attrs.setdefault("error", error)
                self._record(span.name, span._t0, now, depth, attrs,
                             tid=tid)
                closed += 1
        return closed

    def span(self, name: str, **attrs):
        """Open a named span (context manager).  Returns the shared no-op
        span when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def record_span(self, name: str, t0: float, t1: float,
                    tid: int | None = None, **attrs) -> None:
        """Record a span that already ended: ``t0`` to ``t1`` on this
        tracer's clock, at depth 0, on thread ``tid`` (default: this
        one).  For a region that no ``with`` block can enclose, such as
        the job envelope's set-up, which opens in one call and closes in
        another; it has no profiler range."""
        if self.enabled:
            self._record(name, t0, t1, 0, attrs, tid=tid)

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker (demotion, spill begin, snapshot
        cut) — a Chrome ``ph="i"`` instant event."""
        if not self.enabled:
            return
        now = self._clock()
        # the depth is read before taking the lock: a thread's first
        # _stack() call registers its stack under that same lock
        depth = len(self._stack())
        with self._lock:
            self._events.append({
                "name": name, "ph": "i",
                "ts": (now - self._epoch) * 1e6,
                "tid": threading.get_ident(),
                "depth": depth,
                "args": attrs,
            })

    def _record(self, name: str, t0: float, t1: float, depth: int,
                attrs: dict, tid: int | None = None) -> None:
        with self._lock:
            self._events.append({
                "name": name, "ph": "X",
                "ts": (t0 - self._epoch) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "tid": threading.get_ident() if tid is None else tid,
                "depth": depth,
                "args": attrs,
            })

    # --- export -----------------------------------------------------------

    def _tid_map(self) -> dict[int, int]:
        """Compact thread idents to small stable tids (0 = first seen)."""
        tids: dict[int, int] = {}
        for e in self._events:
            tids.setdefault(e["tid"], len(tids))
        return tids

    def chrome_trace(self) -> list[dict]:
        """The event list in Chrome trace-event format (the ``[...]``
        array form both chrome://tracing and Perfetto load)."""
        with self._lock:
            events = list(self._events)
        tids = self._tid_map()
        out = [
            {"name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
             "args": {"name": "map_oxidize_tpu_torch"}},
        ]
        for raw, tid in tids.items():
            out.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                        "tid": tid,
                        "args": {"name": f"thread-{tid}" if tid else
                                 "driver"}})
        for e in events:
            ev = {
                "name": e["name"], "ph": e["ph"], "cat": "moxt",
                "ts": round(e["ts"], 3), "pid": self._pid,
                "tid": tids[e["tid"]],
                "args": _scalarize(e["args"]),
            }
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"], 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            out.append(ev)
        return out

    def write_chrome(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)

    def write_jsonl(self, path: str) -> None:
        """One event per line, with explicit ``depth`` (nesting level at
        open) — the grep/jq-friendly export."""
        with self._lock:
            events = list(self._events)
        tids = self._tid_map()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for e in events:
                row = dict(e, tid=tids[e["tid"]], args=_scalarize(e["args"]))
                f.write(json.dumps(row) + "\n")
        os.replace(tmp, path)


def _scalarize(args: dict) -> dict:
    """JSON-safe attribute values (numpy scalars -> Python scalars)."""
    out = {}
    for k, v in args.items():
        item = getattr(v, "item", None)
        if item is not None and getattr(v, "ndim", 1) == 0:
            v = item()
        elif not isinstance(v, (str, int, float, bool, type(None))):
            v = str(v)
        out[k] = v
    return out
