"""Launch ledger: observe every device program the port runs, by name.

The port of the JAX package's ``obs/compile.py`` (``ProgramStats`` :49,
``CompileLedger`` :83 with ``overlay`` :134, ``record_dispatch`` :243,
``job_delta`` :288, ``_classify`` :371, ``ObservedJit`` :389,
``job_overlay_delta`` :544, ``observed_jit`` :561).  PyTorch
has no jit cache, so the JAX notions map as follows:

* **A compile** is the first dispatch of a program under a new signature
  (tensor shapes and dtypes, and the static arguments): each
  :class:`ObservedProgram` keeps the set of signatures it has run, as a
  jitted function keeps its executable cache.  A recompile
  is named by the same ``_classify`` rules (new input shape, new dtype,
  new static config, signature change).
* **Compile time** is the wall of that first call.  A first call that
  builds or loads a CUDA library (:mod:`~map_oxidize_tpu_torch.ops.build`)
  pays it there; the ``nvcc`` share is reported by the builder through
  :func:`note_backend_compile` into ``backend_compile_ms``.
* **The dispatch gap** is the host wall from the call to its return (a
  CUDA program returns once its launches are queued).
* **The sampled device compute** is taken on the job's 1st dispatch of a
  program, on every compile and then on every ``SAMPLE_EVERY``-th
  dispatch.  On the card a timing CUDA event is recorded on the call's
  stream before the call and another after it; the ledger keeps the pair
  and resolves its ``elapsed_time`` once the end event has completed,
  checked with ``query()`` at later dispatches; the job's
  ``finish_xprof`` waits for the rest of its own pairs, outside the
  ledger's lock (a finished job has synchronised by then).  So the
  sample is the call's own time on its stream, and no dispatch waits for
  the card for it.  A compile's pair also holds the host's build, so its
  sample is the pair less the call's wall: the device time left when the
  call returned (a one-dispatch program such as ``kmeans/fit`` in a
  fresh process has no other sample).  On the CPU a call returns when
  its work is done, so the sample is the call's wall, and the wait after
  it (nothing) is what ``device/compute_ms`` gets, as the call's wall is
  already the dispatch gap (or the compile) of the attribution.  On the
  card ``device/compute_ms`` gets nothing from the ledger: only the
  fetches that block anyway feed it.
* **Per-program costs.** XLA's ``cost_analysis`` has no counterpart, so
  :data:`COSTS` reckons each program's FLOPs and bytes per dispatch from
  its arguments' shapes; :mod:`~map_oxidize_tpu_torch.obs.xprof` joins
  them with the sampled device time into achieved rates and a roofline
  class.  Reckoning the cost of a new signature is this ledger's
  ``lowering`` and is counted into ``attrib/lowering_ms``.

The ledger is process-global; a job sees its own numbers through the
per-job overlay opened by :meth:`CompileLedger.activate` and closed by
:meth:`CompileLedger.deactivate`.  Per dispatch the ledger adds two
``perf_counter`` reads and a dict probe; a sampled dispatch on the card
adds two event records, and a dispatch while samples are pending one
``query()`` each.  No dispatch waits for the device.
"""

from __future__ import annotations

import inspect
import math
import threading
import time

from map_oxidize_tpu_torch.obs.context import current_obs
from map_oxidize_tpu_torch.obs.metrics import loaded_torch
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: sample the device time of the 1st and then every N-th dispatch of each
#: program in a job (bounded sync cost on asynchronous pipelines)
SAMPLE_EVERY = 16


class ProgramStats:
    """Cumulative per-program record, keyed by program name."""

    __slots__ = ("name", "compiles", "compile_ms", "backend_compile_ms",
                 "dispatches", "dispatch_ms", "sampled_ms", "samples",
                 "causes", "sigs", "flops", "bytes_accessed", "chunks",
                 "precision")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.compile_ms = 0.0          # wall of the compiling calls
        self.backend_compile_ms = 0.0  # nvcc time inside them
        self.dispatches = 0
        self.dispatch_ms = 0.0         # call -> return, non-compiling
        self.sampled_ms = 0.0          # sampled device times
        self.samples = 0
        #: logical chunks retired by the non-compiling dispatches (a
        #: batched program retires B per call)
        self.chunks = 0
        self.causes: list[str] = []
        #: signature -> (flops, bytes) of one dispatch
        self.sigs: dict = {}
        self.flops: float | None = None
        self.bytes_accessed: float | None = None
        #: the ``precision`` argument of the newest signature (the
        #: k-means programs), which picks the peak MFU is quoted against
        self.precision: str | None = None

    def snapshot(self) -> tuple:
        return (self.compiles, self.compile_ms, self.backend_compile_ms,
                self.dispatches, self.dispatch_ms, self.sampled_ms,
                self.samples, len(self.causes), self.chunks)


def _new_row() -> dict:
    return {"compiles": 0, "compile_ms": 0.0, "backend_compile_ms": 0.0,
            "dispatches": 0, "dispatch_ms": 0.0, "sampled_ms": 0.0,
            "samples": 0, "chunks": 0, "causes": []}


class CompileLedger:
    """Process-global registry of observed programs plus the recording
    jobs' hookup: a dispatch's histograms and warnings go to the job bound
    to the calling context (``obs.context``), else to the latest
    activated one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.programs: dict[str, ProgramStats] = {}
        #: bumped by :meth:`reset`; a program whose epoch is older forgets
        #: the signatures it has run
        self.epoch = 0
        self._active = None
        self._active_base: dict = {}
        #: id(obs) -> [obs, baseline snapshot, per-job overlay]
        self._actives: dict[int, list] = {}
        self._tls = threading.local()
        #: sampled card dispatches whose end event had not completed:
        #: [stats, job overlay row or None, job, start event, end event,
        #: ms to take off]
        self._pending: list[list] = []

    def reset(self) -> None:
        """Forget every program and every signature a program has run: the
        ledger of a fresh process."""
        with self._lock:
            self.programs = {}
            self._pending = []
            self.epoch += 1

    # --- job lifecycle ----------------------------------------------------

    def activate(self, obs) -> dict:
        """Open ``obs``'s window; returns the baseline its finish deltas
        against."""
        with self._lock:
            self._active = obs
            self._active_base = {n: p.snapshot()
                                 for n, p in self.programs.items()}
            self._actives[id(obs)] = [obs, dict(self._active_base), {}]
            return dict(self._active_base)

    def defer_sample(self, stats: ProgramStats, start, end,
                     less_ms: float = 0.0) -> None:
        """Keep a sampled card dispatch's event pair until its end event
        has completed (:meth:`resolve`); its sample is the pair's time
        less ``less_ms`` (a compile's wall), and not below 0."""
        obs, _base, local = self._job()
        with self._lock:
            row = (local.setdefault(stats.name, _new_row())
                   if local is not None else None)
            self._pending.append([stats, row, obs, start, end, less_ms])

    def resolve(self, obs=None) -> None:
        """Fold in the device time of every pending pair whose end event
        has completed; with ``obs``, wait for the rest of that job's pairs
        first (its finish: a finished job has synchronised, so nothing
        waits; a failed one may still have work queued).  The wait is
        made outside the ledger's lock, so other jobs' dispatches go on
        meanwhile."""
        if not self._pending:
            return
        with self._lock:
            keep, ready = [], []
            for entry in self._pending:
                try:
                    if obs is not None and entry[2] is obs:
                        ready.append((entry, True))
                    elif entry[4].query():
                        ready.append((entry, False))
                    else:
                        keep.append(entry)
                except Exception:  # a failed card: the sample is lost
                    pass
            self._pending = keep
        done = []
        for (stats, row, _owner, start, end, less_ms), wait in ready:
            try:
                if wait:
                    end.synchronize()
                done.append((stats, row,
                             max(start.elapsed_time(end) - less_ms, 0.0)))
            except Exception:
                pass
        if not done:
            return
        with self._lock:
            for stats, row, ms in done:
                stats.sampled_ms += ms
                stats.samples += 1
                if row is not None:
                    row["sampled_ms"] += ms
                    row["samples"] += 1

    def deactivate(self, obs) -> "dict | None":
        """Close the job's window; returns its overlay (what
        :meth:`job_delta` reads)."""
        with self._lock:
            entry = self._actives.pop(id(obs), None)
            if self._active is obs:
                if self._actives:
                    other = next(iter(self._actives.values()))
                    self._active, self._active_base = other[0], other[1]
                else:
                    self._active, self._active_base = None, {}
        return entry[2] if entry is not None else None

    def overlay(self, obs) -> "dict | None":
        """Copy of a still-active job's overlay (JAX ``obs/compile.py:134``):
        the live ``/status`` table, the ``/jobs`` rows and the series
        read it without closing the window."""
        with self._lock:
            entry = self._actives.get(id(obs))
            return ({n: dict(r, causes=list(r["causes"]))
                     for n, r in entry[2].items()}
                    if entry is not None else None)

    def job_compile_ms(self, obs) -> float:
        """Compiling-call wall recorded so far in ``obs``'s open window
        (0 once it closed)."""
        with self._lock:
            entry = self._actives.get(id(obs))
            return (sum(r["compile_ms"] for r in entry[2].values())
                    if entry is not None else 0.0)

    def _job(self) -> list:
        """The [obs, baseline, overlay] a dispatch belongs to."""
        cur = current_obs()
        if cur is not None:
            entry = self._actives.get(id(cur))
            if entry is not None:
                return entry
        entry = self._actives.get(id(self._active))
        if entry is not None:
            return entry
        return [self._active, self._active_base, None]

    # --- recording --------------------------------------------------------

    def _stats(self, name: str) -> ProgramStats:
        p = self.programs.get(name)
        if p is None:
            with self._lock:
                p = self.programs.setdefault(name, ProgramStats(name))
        return p

    def record_compile(self, stats: ProgramStats, sig, cause: str,
                       wall_ms: float, cost,
                       backend_ms: float = 0.0) -> None:
        with self._lock:
            stats.compiles += 1
            stats.compile_ms += wall_ms
            if cause != "first":
                stats.causes.append(cause)
            if sig is not None:
                stats.sigs[sig] = cost
            if cost is not None:
                stats.flops, stats.bytes_accessed = cost
        obs, base, local = self._job()
        job_compiles = stats.compiles - base.get(stats.name, (0,))[0]
        if local is not None:
            with self._lock:
                row = local.setdefault(stats.name, _new_row())
                row["compiles"] += 1
                row["compile_ms"] += wall_ms
                row["backend_compile_ms"] += backend_ms
                if cause != "first":
                    row["causes"].append(cause)
                job_compiles = row["compiles"]
        # warn on a program compiling twice within ONE job (a shape-set
        # leak); later jobs compiling new shapes are the delta's business
        if job_compiles > 1 and obs is not None:
            line = (f"[xprof] recompile #{job_compiles} of {stats.name} "
                    f"this job: {cause} ({len(stats.sigs)} input-shape "
                    "sets)")
            hb = obs.heartbeat
            if hb is not None and not hb.silent:
                hb._emit(line)
            else:
                # a silent tracking-only heartbeat (live plane without
                # progress lines) must not swallow the warning
                _log.warning("%s", line)

    def record_dispatch(self, stats: ProgramStats, gap_ms: float,
                        ready_ms: float | None, compiled: bool,
                        chunks: int = 1, batched: bool = False,
                        wait_ms: float | None = None) -> None:
        """A compiling call's wall is compile time, not dispatch gap: it
        stays out of the gap histogram and the dispatch wall.  ``chunks``
        is the number of real logical chunks the dispatch retired; a
        ``batched`` program also lands ``device/dispatch_gap_per_chunk_ms``
        (gap / chunks), comparable across B.  ``ready_ms`` is the sampled
        device time where it is known at once (the CPU; a card's sample
        comes later, through :meth:`defer_sample`); ``wait_ms`` (default:
        the same) the part of it the host waited after the call returned,
        which ``device/compute_ms`` gets."""
        with self._lock:
            stats.dispatches += 1
            if not compiled:
                stats.dispatch_ms += gap_ms
                stats.chunks += chunks
            if ready_ms is not None:
                stats.sampled_ms += ready_ms
                stats.samples += 1
        obs, _base, local = self._job()
        if local is not None:
            with self._lock:
                row = local.setdefault(stats.name, _new_row())
                row["dispatches"] += 1
                if not compiled:
                    row["dispatch_ms"] += gap_ms
                    row["chunks"] += chunks
                if ready_ms is not None:
                    row["sampled_ms"] += ready_ms
                    row["samples"] += 1
        if obs is not None:
            if not compiled:
                obs.registry.observe("device/dispatch_gap_ms", gap_ms)
                if batched:
                    obs.registry.observe("device/dispatch_gap_per_chunk_ms",
                                         gap_ms / chunks)
            if ready_ms is not None:
                obs.registry.observe("device/compute_ms",
                                     ready_ms if wait_ms is None else wait_ms)

    # --- export -----------------------------------------------------------

    def job_delta(self, baseline: dict, local: "dict | None" = None
                  ) -> dict:
        """Per-program activity of one job window (programs with neither a
        compile nor a dispatch in it are left out): from the job's overlay
        when given, else the global counts minus ``baseline``.  Costs and
        shape sets are global program facts either way."""
        out = {}
        with self._lock:
            items = list(self.programs.items())
        if local is not None:
            stats = dict(items)
            rows = [(name, row, stats.get(name))
                    for name, row in local.items()]
        else:
            rows = []
            for name, p in items:
                b = baseline.get(name, (0, 0.0, 0.0, 0, 0.0, 0.0, 0, 0, 0))
                rows.append((name, {
                    "compiles": p.compiles - b[0],
                    "compile_ms": p.compile_ms - b[1],
                    "backend_compile_ms": p.backend_compile_ms - b[2],
                    "dispatches": p.dispatches - b[3],
                    "dispatch_ms": p.dispatch_ms - b[4],
                    "sampled_ms": p.sampled_ms - b[5],
                    "samples": p.samples - b[6],
                    "causes": p.causes[b[7]:],
                    "chunks": p.chunks - b[8]}, p))
        for name, row, p in rows:
            if row["compiles"] <= 0 and row["dispatches"] <= 0:
                continue
            out[name] = {
                "compiles": row["compiles"],
                "compile_ms": round(row["compile_ms"], 3),
                "backend_compile_ms": round(row["backend_compile_ms"], 3),
                "dispatches": row["dispatches"],
                "dispatch_ms": round(row["dispatch_ms"], 3),
                "sampled_device_ms": round(row["sampled_ms"], 3),
                "device_samples": row["samples"],
                "logical_chunks": row["chunks"],
                "recompile_causes": list(row["causes"]),
                "shape_sets": len(p.sigs) if p is not None else 0,
                "flops_per_dispatch": p.flops if p else None,
                "bytes_per_dispatch": p.bytes_accessed if p else None,
                "precision": p.precision if p else None,
            }
        return out


#: the process ledger every observed program records into
LEDGER = CompileLedger()


def job_overlay_delta(obs) -> dict:
    """Live per-program compile/dispatch delta of a STILL-RECORDING job
    (JAX ``obs/compile.py:544``): the activity routed to this job by its
    overlay, disjoint from concurrent jobs' in one process.  The ``/jobs``
    rows, the live attribution and the resident server's warm-compile
    evidence read it mid-run; ``Obs.finish_xprof`` keeps the end-of-job
    export.  ``{}`` for a job whose window never opened or already
    closed."""
    base = getattr(obs, "xprof_base", None)
    if base is None:
        return {}
    local = LEDGER.overlay(obs)
    if local is None:
        return {}
    return LEDGER.job_delta(base, local)


def note_backend_compile(ms: float) -> None:
    """Credit ``ms`` of kernel compilation (``nvcc``) to the program whose
    call is running on this thread, if any."""
    cur = getattr(LEDGER._tls, "current", None)
    if cur is not None:
        cur.backend_compile_ms += ms


# --- signatures -------------------------------------------------------------


def _leaves(x, out: list) -> list:
    """Flatten tuples, lists and dicts (keys sorted) as a pytree does;
    None is no leaf."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif x is not None:
        out.append(x)
    return out


def _sig_of(args, kw) -> tuple:
    """Hashable signature of a call: (shape, dtype) per tensor or array
    leaf, ``repr`` for every other leaf."""
    sig = []
    for leaf in _leaves((args, kw), []):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            sig.append(("t", tuple(shape), str(dtype)))
        else:
            sig.append(("v", repr(leaf)))
    return tuple(sig)


def _classify(sig, seen: dict) -> str:
    """Name the recompile cause by diffing ``sig`` against seen ones."""
    shapes = tuple(s[1] for s in sig if s[0] == "t")
    dtypes = tuple(s[2] for s in sig if s[0] == "t")
    statics = tuple(s[1] for s in sig if s[0] == "v")
    for old in seen:
        o_shapes = tuple(s[1] for s in old if s[0] == "t")
        o_dtypes = tuple(s[2] for s in old if s[0] == "t")
        o_statics = tuple(s[1] for s in old if s[0] == "v")
        if shapes != o_shapes and dtypes == o_dtypes and statics == o_statics:
            return "new_input_shape"
        if shapes == o_shapes and dtypes != o_dtypes:
            return "new_dtype"
        if shapes == o_shapes and dtypes == o_dtypes and statics != o_statics:
            return "new_static_config"
    return "signature_change"


# --- per-program costs ------------------------------------------------------


def _nbytes(t) -> int:
    return int(math.prod(t.shape)) * t.element_size()


def _sort_ops(n: int) -> float:
    """Comparisons of one sort of ``n`` rows (n log2 n)."""
    return float(n * max(1, math.ceil(math.log2(max(n, 2)))))


def _merge_cost(acc_keys, acc_vals, batch_rows: int, batch_bytes: int,
                merges: int = 1):
    """A fold of ``merges`` batches of ``batch_rows`` rows into a
    ``C``-row accumulator: each merge sorts ``C + N`` order keys and
    combines their values (one op per value element per segment step);
    bytes are the accumulator read and written once per merge plus the
    batches read once."""
    c = acc_keys.shape[0]
    width = int(math.prod(acc_vals.shape[1:]))
    rows = c + batch_rows
    flops = merges * (_sort_ops(rows) + 4.0 * rows * width)
    acc = _nbytes(acc_keys) + _nbytes(acc_vals)
    return flops, float(merges * 2 * acc + batch_bytes)


def _cost_merge(acc_keys, acc_vals, ovf, b_keys, b_vals, combine="sum"):
    return _merge_cost(acc_keys, acc_vals, b_keys.shape[0],
                       _nbytes(b_keys) + _nbytes(b_vals))


def _cost_merge_packed(acc_keys, acc_vals, ovf, packed, combine="sum"):
    return _merge_cost(acc_keys, acc_vals, packed.shape[-1],
                       _nbytes(packed))


def _cost_merge_packed_batch(acc_keys, acc_vals, ovf, stacked,
                             combine="sum"):
    return _merge_cost(acc_keys, acc_vals, stacked.shape[-1],
                       _nbytes(stacked), merges=stacked.shape[0])


def _cost_pack_finalize(keys, vals, n_unique, ovf):
    c = keys.shape[0]
    return 3.0 * c, float(_nbytes(keys) + _nbytes(vals) + 3 * 8 * (c + 1))


def _cost_grow_concat(keys, vals, p_keys, p_vals):
    moved = _nbytes(keys) + _nbytes(vals) + _nbytes(p_keys) + _nbytes(p_vals)
    return None, float(2 * moved)


def _cost_top_k(keys, vals, k):
    c = keys.shape[0]
    return _sort_ops(c) + c, float(_nbytes(keys) + _nbytes(vals)
                                   + k * (keys.element_size()
                                          + vals.element_size()))


def _cost_collect_sort(stacked):
    n = stacked.shape[-1]
    return 2.0 * _sort_ops(n), float(2 * _nbytes(stacked))


def _cost_tokenize(chunk, max_tokens, out_keys, fetch_keys, ngram=1):
    n = chunk.shape[0]
    return (16.0 * n + _sort_ops(max_tokens) + 4.0 * max_tokens,
            float(n + 12 * max_tokens + 16 * out_keys
                  + 4 * (3 + 3 * fetch_keys)))


def _cost_prefix_pack(u_hi, u_lo, reps, m):
    return float(m), float(2 * 3 * 4 * m)


def assign_sum_ops(n: int, k: int, d: int) -> float:
    """Operations one fused assign + sum needs: a multiply and an add per
    point, centroid and dimension for the scores, an add per point and
    dimension for the sums."""
    return 2.0 * n * k * d + n * d


def _cost_kmeans_step(c, p, k, precision="highest"):
    n, d = p.shape
    return assign_sum_ops(n, k, d), float(_nbytes(p) + 2 * _nbytes(c))


def _cost_kmeans_fit(c, p, k, iters, precision="highest"):
    n, d = p.shape
    return assign_sum_ops(n, k, d) * iters, float(iters * _nbytes(p)
                                                   + 2 * _nbytes(c))


def _cost_stream_step(block, c, acc, chunk_rows, **_statics):
    n, d = block.shape
    k = c.shape[0]
    return assign_sum_ops(n, k, d), float(_nbytes(block) + _nbytes(c)
                                           + 2 * _nbytes(acc))


def _sum_bytes(ts) -> int:
    return sum(_nbytes(t) for t in ts)


def _cost_shuffle_merge(mesh, acc_keys, acc_vals, ovf, b_keys, b_vals,
                        *, cap, **_statics):
    S = len(acc_keys)
    c = acc_keys[0].shape[0]
    width = int(math.prod(acc_vals[0].shape[1:]))
    b = b_keys[0].shape[0]
    rows = c + S * cap
    flops = S * (2 * _sort_ops(b) + 4.0 * b * width + _sort_ops(rows)
                 + 4.0 * rows * width)
    acc = _sum_bytes(acc_keys) + _sum_bytes(acc_vals)
    sent = S * S * cap * (8 + acc_vals[0].element_size() * width)
    return flops, float(2 * acc + _sum_bytes(b_keys) + _sum_bytes(b_vals)
                        + 2 * sent)


def _cost_shuffle_top_k(mesh, acc_keys, acc_vals, *, k_local, k_final):
    S = len(acc_keys)
    c = acc_keys[0].shape[0]
    return (S * (_sort_ops(c) + c) + 2 * _sort_ops(S * k_local),
            float(_sum_bytes(acc_keys) + _sum_bytes(acc_vals)
                  + 2 * S * S * k_local * 12 + k_final * 12))


def _cost_shuffle_grow(mesh, acc_keys, acc_vals, pad, combine="sum"):
    moved = _sum_bytes(acc_keys) + _sum_bytes(acc_vals)
    return None, float(2 * moved + len(acc_keys) * pad * 12)


def _cost_init_acc(mesh, capacity, value_shape, value_dtype,
                   combine="sum"):
    width = int(math.prod(value_shape)) if value_shape else 1
    return None, float(mesh.size * capacity * (8 + 4 * width))


def _cost_route_append(mesh, buf_keys, buf_docs, cursor, keys, docs, *,
                       cap, **_statics):
    S = len(keys)
    b = keys[0].shape[0]
    rows = S * cap
    return (S * (_sort_ops(b) + _sort_ops(rows) + 4.0 * b),
            float(_sum_bytes(keys) + _sum_bytes(docs) + 2 * S * rows * 16))


def _cost_collect_grow(mesh, buf_keys, buf_docs, pad):
    moved = _sum_bytes(buf_keys) + _sum_bytes(buf_docs)
    return None, float(2 * moved + 2 * len(buf_keys) * pad * 8)


def _cost_sort_sharded(mesh, buf_keys, buf_docs):
    n = sum(t.shape[0] for t in buf_keys)
    return (2.0 * _sort_ops(n),
            float(2 * (_sum_bytes(buf_keys) + _sum_bytes(buf_docs))))


def _cost_fit_sharded(mesh, p, c, k, loop_iters, precision="highest"):
    n = sum(t.shape[0] for t in p)
    d = c[0].shape[1]
    return (assign_sum_ops(n, k, d) * loop_iters,
            float(loop_iters * _sum_bytes(p) + 2 * _nbytes(c[0])))


def _cost_stream_step_sharded(mesh, blocks, c, acc, per_shard,
                              **_statics):
    n = sum(t.shape[0] for t in blocks)
    d = c[0].shape[1]
    k = c[0].shape[0]
    return assign_sum_ops(n, k, d), float(_sum_bytes(blocks)
                                           + _nbytes(c[0])
                                           + 2 * _nbytes(acc))


def _cost_tokenize_group(chunks, *, max_tokens, out_keys, fetch_keys,
                         ngram=1):
    per = _cost_tokenize(chunks[0], max_tokens, out_keys, fetch_keys)
    return per[0] * len(chunks), per[1] * len(chunks)


def _cost_stream_step_any(*args, **kw):
    if isinstance(args[0], (list, tuple)) or hasattr(args[0], "devices"):
        return _cost_stream_step_sharded(*args, **kw)
    return _cost_stream_step(*args, **kw)


#: program name -> ``(args, kw) -> (flops, bytes)`` of ONE dispatch from
#: its arguments' shapes.  What each row counts:
#:
#: * ``engine/merge``, ``engine/merge_packed``: one sort of the ``C + N``
#:   order keys (``n log2 n`` comparisons) plus 4 ops per value element;
#:   bytes = the accumulator read and written once, the batch read once;
#: * ``engine/merge_packed_batch``: the same, times the B stacked batches;
#: * ``engine/pack_finalize``: 3 ops per row (key split, value widen);
#:   bytes = the accumulator read, the ``(3, C+1)`` int64 pack written;
#: * ``engine/grow_concat``: a copy, no FLOPs (None, as XLA reports it);
#:   bytes = old and pad rows read, the grown accumulator written;
#: * ``engine/top_k``: one stable sort of the C values plus the padding
#:   mask; bytes = keys and values read, k rows written;
#: * ``collect/sort``: two stable 64-bit sorts of the N pairs; bytes =
#:   the ``(4, N)`` block read and written;
#: * ``device_map/tokenize``: 16 ops per byte (boundary test, two hash
#:   lanes' Horner steps) plus the dedup sort of ``max_tokens`` rows;
#:   bytes = the chunk read, the token rows written and read back, the
#:   unique rows and the packed row written;
#: * ``device_map/prefix_pack``: m ops (the rep plane's u32 conversion, as
#:   XLA counts it); bytes = 3m u32 read and written;
#: * ``kmeans/step``, ``kmeans/stream_step``: 2 n k d + n d, what the
#:   fused kernel needs (the scores, then the sums; the count the
#:   benchmark's roofline of ``kmeans_assign_sum`` takes); bytes = the
#:   points read once, the centroids read and written (the stream step:
#:   its ``(k, d+1)`` partial too);
#: * ``kmeans/fit``: ``iters`` steps; the points are re-read every one;
#: * the sharded programs (``shuffle/*``, ``collect/route_append``,
#:   ``collect/grow``, ``collect/sort_sharded``, ``kmeans/fit_sharded``,
#:   the sharded ``kmeans/stream_step``, ``device_map/tokenize_group``):
#:   the same counts summed over the shards; the exchanges also move the
#:   ``[S, S, cap]`` send buffers once out and once in;
#:   ``shuffle/init_acc`` and the grows are fills and copies, no FLOPs.
COSTS = {
    "engine/merge": _cost_merge,
    "engine/merge_packed": _cost_merge_packed,
    "engine/merge_packed_batch": _cost_merge_packed_batch,
    "engine/pack_finalize": _cost_pack_finalize,
    "engine/grow_concat": _cost_grow_concat,
    "engine/top_k": _cost_top_k,
    "collect/sort": _cost_collect_sort,
    "device_map/tokenize": _cost_tokenize,
    "device_map/prefix_pack": _cost_prefix_pack,
    "kmeans/step": _cost_kmeans_step,
    "kmeans/fit": _cost_kmeans_fit,
    "kmeans/stream_step": _cost_stream_step_any,
    "shuffle/merge": _cost_shuffle_merge,
    "shuffle/top_k": _cost_shuffle_top_k,
    "shuffle/grow": _cost_shuffle_grow,
    "shuffle/init_acc": _cost_init_acc,
    "collect/route_append": _cost_route_append,
    "collect/grow": _cost_collect_grow,
    "collect/sort_sharded": _cost_sort_sharded,
    "kmeans/fit_sharded": _cost_fit_sharded,
    "device_map/tokenize_group": _cost_tokenize_group,
}


def _cost_of(name: str, args, kw):
    fn = COSTS.get(name)
    if fn is None:
        return None
    try:
        fl, by = fn(*args, **kw)
    except Exception:  # a cost the shapes cannot give is not an error
        return None
    return (fl if fl and fl > 0 else None, by if by and by > 0 else None)


def _precision_of(name: str, args, kw) -> "str | None":
    """The ``precision`` argument of a call (the k-means programs), bound
    by its cost row's signature; None for a program without one."""
    if "precision" in kw:
        return kw["precision"]
    fn = COSTS.get(name)
    if fn is None:
        return None
    try:
        bound = inspect.signature(fn).bind(*args, **kw)
    except (TypeError, ValueError):
        return None
    bound.apply_defaults()
    return bound.arguments.get("precision")


# --- the wrapper ------------------------------------------------------------


def _first_tensor(x):
    for leaf in _leaves(x, []):
        if getattr(leaf, "device", None) is not None and hasattr(
                leaf, "element_size"):
            return leaf
    return None


def _sample_stream(args):
    """The CUDA stream a sampled call runs on, for its start event: the
    current stream of its first tensor argument's card, or, for a call
    with no tensor argument in a process that has initialised CUDA, of the
    current card; None for a call on the CPU."""
    t = _first_tensor(args)
    if t is not None:
        if t.device.type != "cuda":
            return None
        import torch

        return torch.cuda.current_stream(t.device)
    torch = loaded_torch()
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def _timing_event(stream):
    """A timing CUDA event recorded now on ``stream``."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class ObservedProgram:
    """A device program under compile/dispatch observation (JAX
    ``ObservedJit``).  Keyword arguments named in ``dynamic`` are data,
    not shape: they stay out of the signature, as an array's values do.
    ``observed_chunks=N`` (reserved, not forwarded) declares the real
    logical chunks of one dispatch; ``chunks_of(*args, **kw)`` derives
    it from the arguments."""

    def __init__(self, name: str, fn, chunks_of=None, dynamic: tuple = (),
                 ledger: CompileLedger | None = None,
                 sample_every: int = SAMPLE_EVERY):
        self.name = name
        self._fn = fn
        self._chunks_of = chunks_of
        self._dynamic = frozenset(dynamic)
        self._ledger = ledger if ledger is not None else LEDGER
        self._sample_every = sample_every
        #: the signatures this program has run (its "executable cache")
        self._seen: set = set()
        self._epoch = self._ledger.epoch

    def __call__(self, *args, observed_chunks=None, **kw):
        led = self._ledger
        if self._epoch != led.epoch:
            self._seen, self._epoch = set(), led.epoch
        stats = led._stats(self.name)
        static_kw = ({k: v for k, v in kw.items() if k not in self._dynamic}
                     if self._dynamic else kw)
        sig = _sig_of(args, static_kw)
        chunks = 1
        if observed_chunks is not None:
            chunks = max(1, int(observed_chunks))
        elif self._chunks_of is not None:
            chunks = max(1, int(self._chunks_of(*args, **kw)))
        cost = None
        new_sig = sig not in stats.sigs
        if new_sig:
            t_cost = time.perf_counter()
            cost = _cost_of(self.name, args, kw)
            stats.precision = _precision_of(self.name, args, kw)
            obs = led._job()[0]
            if obs is not None and obs.current_phase:
                obs.registry.count("attrib/lowering_ms",
                                   (time.perf_counter() - t_cost) * 1e3)
        # claim the signature before the call: of two jobs calling a new
        # signature at once in one process, exactly one compiles (a jit
        # cache compiles once too); a failed first call gives it back
        with led._lock:
            compiled = sig not in self._seen
            self._seen.add(sig)
        # sample on the job's own dispatch ordinal: its first dispatch of
        # every program is always sampled
        _obs, jbase, jlocal = led._job()
        if jlocal is not None:
            lrow = jlocal.get(self.name)
            n = (lrow["dispatches"] if lrow else 0) + 1
        else:
            base = jbase.get(self.name)
            n = stats.dispatches - (base[3] if base else 0) + 1
        sampled = n <= 1 or n % self._sample_every == 0 or compiled
        stream = start = None
        if sampled:
            stream = _sample_stream(args)
            if stream is not None:
                start = _timing_event(stream)
        tls = led._tls
        prev, tls.current = getattr(tls, "current", None), stats
        bc0 = stats.backend_compile_ms
        t0 = time.perf_counter()
        try:
            out = self._fn(*args, **kw)
        except BaseException:
            if compiled:
                with led._lock:
                    self._seen.discard(sig)
            raise
        finally:
            tls.current = prev
        gap_ms = (time.perf_counter() - t0) * 1e3
        if compiled:
            cause = ("first" if not stats.sigs
                     else _classify(sig, stats.sigs) if new_sig
                     else "retrace_same_signature")
            led.record_compile(stats, sig if new_sig else None, cause,
                               gap_ms, cost,
                               backend_ms=stats.backend_compile_ms - bc0)
        elif new_sig:
            with led._lock:
                stats.sigs.setdefault(sig, cost)
                if cost is not None and stats.flops is None:
                    stats.flops, stats.bytes_accessed = cost
        led.resolve()
        ready_ms = wait_ms = None
        if sampled:
            t = _first_tensor(out)
            if t is None:
                t = _first_tensor(args)
            if t is None or t.device.type != "cuda":
                # the CPU: the call's wall is its device time
                ready_ms, wait_ms = gap_ms, 0.0
            elif start is not None:
                end = _timing_event(stream)
                # a compiling call's pair holds the host's build: its
                # sample is the pair less the call's wall
                led.defer_sample(stats, start, end,
                                 gap_ms if compiled else 0.0)
        led.record_dispatch(stats, gap_ms, ready_ms, compiled,
                            chunks=chunks,
                            batched=(observed_chunks is not None
                                     or self._chunks_of is not None),
                            wait_ms=wait_ms)
        return out


def observed(name: str, fn=None, **kw):
    """Observe ``fn`` under the stable program ``name`` (usable as a
    decorator: ``@observed("engine/merge")``).  The name is the join key
    of everything downstream (compile counts, costs, the ``xprof`` rows,
    the calibration store), so it carries no per-job salt."""
    if fn is None:
        return lambda f: ObservedProgram(name, f, **kw)
    return ObservedProgram(name, fn, **kw)
