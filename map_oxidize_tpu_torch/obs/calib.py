"""Persistent cross-run calibration store: measured collective and
program costs that survive the process.  A copy of the JAX package's
``obs/calib.py`` (``run_identity`` :123, ``CalibStore`` :180,
``validate_doc`` :418, ``program_curve`` :450, ``workload_curve`` :472,
``interpolate_latency_ms`` :503, the coverage plane :551-685 and
``render`` :694) in the same ``moxt-calib-v1`` schema, so a store written
by either package loads and merges in the other.

* one versioned JSON document (``<calib_dir>/calib.json``) holding
  **comms rows** keyed ``(platform, device-count, topology, collective,
  program, shape-bucket, source)``, **program rows** keyed ``(platform,
  device-count, topology, program)`` (dispatches, dispatch wall, sampled
  device compute, compiles) and **workload rows** keyed ``(platform,
  device-count, topology, workload)`` (corpus bytes, wall, and wall per
  attribution bucket: what the planner's wall prediction reads);
* loaded by ``Obs.from_config`` (``obs.calib_prior``), accumulated from
  the job's launch-ledger report and attribution at ``Obs.finish``, and
  merged into the file under an ``flock`` with temp + rename, so
  concurrent finishing processes interleave safely;
* merges refuse mismatches (:class:`CalibMismatch`): an unknown schema or
  version, or a row whose key disagrees with its identity fields.

The read side (:func:`program_curve`, :func:`workload_curve`,
:func:`interpolate_latency_ms`) turns the accumulated mass back into the
per-call and per-MB rates the dispatch resolver and the planner consume.
The port records no collectives yet (one device), so its runs add program
and workload rows only.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

from map_oxidize_tpu_torch.obs.metrics import format_bytes as _fmt_bytes
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

CALIB_SCHEMA = "moxt-calib-v1"
CALIB_VERSION = 1
CALIB_FILE = "calib.json"

#: identity fields every row carries (and its key encodes).  ``source``
#: is evidence provenance — ``"job"`` rows accumulated as a side effect
#: of real runs, ``"probe"`` rows written by the deterministic
#: microbenchmark harness (the JAX package's ``obs/probe.py``) — kept IN
#: the identity so the two never merge into one row (never
#: double-trusted), while the read-side curves pool them explicitly.
_COMM_IDENTITY = ("platform", "device_count", "topology", "collective",
                  "program", "shape_bucket", "source")
_PROG_IDENTITY = ("platform", "device_count", "topology", "program")
_WORKLOAD_IDENTITY = ("platform", "device_count", "topology", "workload")

#: legal evidence provenance tags (trailing ``_COMM_IDENTITY`` field)
_SOURCES = ("job", "probe")

#: ``obs diff --gate``: coverage dropping more than this many points
#: against the baseline entry flags (JAX ``obs/calib.py:76``)
CALIB_COVERAGE_GATE_POINTS = 10.0

#: selection floor: below this many sampled latencies in the exact
#: bucket the chooser refuses to trust a curve (named reason, default
#: kept) — 1–2 samples is an anecdote, not evidence
CALIB_MIN_SAMPLES = 3

#: the exchange programs the collective chooser prices (the JAX
#: package's ``parallel.shuffle.EXCHANGE_COLLECTIVES``)
EXCHANGE_COLLECTIVE_NAMES = ("all_to_all", "all_gather")


def exchange_shape(num_shards: int, batch_size: int,
                   collect: bool = False) -> tuple:
    """The ``(bucket_cap, value_row_bytes)`` the engines will derive for
    a job of this shape — the JAX package's fold-engine cap
    derivation (``parallel.shuffle.build_sharded_ops``) and the
    pair-collect engines' full-batch cap, shared by the planner's
    chooser call and ``obs calib coverage`` so both price the exchange
    at the same payload bucket the run will record."""
    S = max(int(num_shards), 1)
    bps = max(1, int(batch_size) // S)
    if collect:
        return bps, 8
    return min(bps, 2 * (-(-bps // S)) + 16), 4


class CalibMismatch(ValueError):
    """The store (or a merge source) is not compatible: wrong schema/
    version, or a row's key disagrees with its identity fields."""


def shape_bucket(nbytes_per_call: float) -> str:
    """Power-of-two payload bucket label: ``"64KB"`` = [64KB, 128KB)."""
    n = int(nbytes_per_call)
    if n <= 0:
        return "0B"
    k = n.bit_length() - 1
    floor = 1 << k
    for scale, suffix in ((1 << 40, "TB"), (1 << 30, "GB"),
                          (1 << 20, "MB"), (1 << 10, "KB")):
        if floor >= scale:
            return f"{floor // scale}{suffix}"
    return f"{floor}B"


def run_identity(n_processes: int = 1) -> dict:
    """This run's (platform, device-count, topology) triple, read from an
    already-initialised torch (never initialising CUDA): ``"gpu"`` once
    this process has initialised CUDA (the JAX package's name for an
    NVIDIA device, so a store means the same in both packages), ``"cpu"``
    once a job resolved the CPU as its device (``backend='cpu'``), and
    ``"host"`` otherwise."""
    platform, count = "host", 0
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        platform, count = "gpu", torch.cuda.device_count()
    elif _RESOLVED_CPU[0]:
        platform, count = "cpu", 1
    return {
        "platform": platform,
        "device_count": count,
        "topology": f"{max(n_processes, 1)}x{count}",
    }


#: set once a job of this process resolved the CPU as its device
_RESOLVED_CPU = [False]


def note_cpu_device() -> None:
    """Record that a job resolved the CPU as its device (the device
    resolve calls this), so :func:`run_identity` reads ``"cpu"``."""
    _RESOLVED_CPU[0] = True


def _comm_key(ident: dict, collective: str, program: str,
              bucket: str, source: str = "job") -> str:
    return "|".join([ident["platform"], str(ident["device_count"]),
                     ident["topology"], collective, program, bucket,
                     source])


def _normalize_legacy_comms(doc: dict) -> None:
    """Rewrite pre-``source`` comms rows (6-part keys) in place to the
    7-part form, tagging them ``source="job"`` — every legacy row WAS
    organic job evidence.  Runs before :func:`validate_doc` so a store
    written by an older build still loads/merges instead of refusing."""
    if not isinstance(doc, dict):
        return
    comms = doc.get("comms")
    if not isinstance(comms, dict):
        return
    legacy = [k for k in comms
              if isinstance(k, str)
              and len(k.split("|")) == len(_COMM_IDENTITY) - 1]
    for key in legacy:
        row = comms.pop(key)
        if isinstance(row, dict):
            row.setdefault("source", "job")
        comms[key + "|job"] = row


def _prog_key(ident: dict, program: str) -> str:
    return "|".join([ident["platform"], str(ident["device_count"]),
                     ident["topology"], program])


def _workload_key(ident: dict, workload: str) -> str:
    return "|".join([ident["platform"], str(ident["device_count"]),
                     ident["topology"], workload])


class CalibStore:
    """In-memory form of the store document, with accumulate/merge/save.

    ``doc`` is the JSON shape on disk: ``{"schema", "version", "comms":
    {key: row}, "programs": {key: row}, "runs", "updated_unix_s"}``."""

    def __init__(self, path: str | None = None, doc: dict | None = None):
        self.path = path
        self.doc = doc if doc is not None else {
            "schema": CALIB_SCHEMA, "version": CALIB_VERSION,
            "comms": {}, "programs": {}, "runs": 0,
        }

    # --- load / validate --------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "CalibStore":
        """Load ``<path>`` (a calib.json, or a directory holding one).
        A missing file is an empty store; an incompatible one REFUSES
        (:class:`CalibMismatch`) — stale evidence must never silently
        merge with a new schema's."""
        if os.path.isdir(path):
            path = os.path.join(path, CALIB_FILE)
        store = cls(path=path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return store
        except (OSError, ValueError) as e:
            raise CalibMismatch(f"unreadable calibration store {path!r}: "
                                f"{e}") from e
        _normalize_legacy_comms(doc)
        validate_doc(doc, path)
        store.doc = doc
        return store

    # --- accumulation (one run's measurements) ----------------------------

    def accumulate_run(self, ident: dict, comms_rows: list | None,
                       xprof_report: dict | None,
                       source: str = "job") -> int:
        """Fold one finished run's comms table + xprof program rows into
        this store under ``ident``, tagged with evidence ``source``
        (``"job"`` for organic runs, ``"probe"`` for the microbenchmark
        harness).  Returns the number of rows touched."""
        if source not in _SOURCES:
            raise ValueError(f"source must be one of {_SOURCES}, "
                             f"got {source!r}")
        touched = 0
        for r in comms_rows or []:
            calls = int(r.get("count") or 0)
            nbytes = float(r.get("bytes") or 0.0)
            if calls <= 0:
                continue
            bucket = shape_bucket(nbytes / calls)
            key = _comm_key(ident, r["collective"], r["program"], bucket,
                            source)
            row = self.doc["comms"].get(key)
            if row is None:
                row = self.doc["comms"][key] = dict(
                    ident, collective=r["collective"],
                    program=r["program"], shape_bucket=bucket,
                    source=source, calls=0, bytes=0.0, latency_ms=0.0,
                    latency_samples=0, runs=0)
            lat = r.get("latency_ms") or {}
            samples = int(lat.get("count") or 0)
            row["calls"] += calls
            row["bytes"] += nbytes
            row["latency_ms"] += float(lat.get("mean") or 0.0) * samples
            row["latency_samples"] += samples
            row["runs"] += 1
            row["last_shape"] = r.get("shape")
            touched += 1
        for name, p in ((xprof_report or {}).get("programs") or {}).items():
            dispatches = int(p.get("dispatches") or 0)
            compiles = int(p.get("compiles") or 0)
            if dispatches <= 0 and compiles <= 0:
                continue
            key = _prog_key(ident, name)
            row = self.doc["programs"].get(key)
            if row is None:
                row = self.doc["programs"][key] = dict(
                    ident, program=name, dispatches=0, dispatch_ms=0.0,
                    compute_ms=0.0, compute_samples=0, compiles=0,
                    compile_ms=0.0, runs=0)
            row["dispatches"] += dispatches
            row["dispatch_ms"] += float(p.get("dispatch_ms") or 0.0)
            row["compute_ms"] += float(p.get("sampled_device_ms") or 0.0)
            row["compute_samples"] += int(p.get("device_samples") or 0)
            row["compiles"] += compiles
            row["compile_ms"] += float(p.get("compile_ms") or 0.0)
            row["runs"] += 1
            touched += 1
        if touched:
            self.doc["runs"] = int(self.doc.get("runs") or 0) + 1
        return touched

    def accumulate_workload(self, ident: dict, workload: str,
                            corpus_bytes: float,
                            attrib_doc: dict | None) -> int:
        """Fold one finished run's wall attribution into the per-workload
        curve row under ``ident`` — the mass :func:`workload_curve`
        turns back into the planner's per-MB wall prediction.  Bucket
        fields are flat (``bucket_<name>_ms``) so the generic numeric
        merge in :meth:`merge_from` accumulates them like any other
        counter.  Returns rows touched (0/1)."""
        if not workload or not attrib_doc:
            return 0
        wall = float(attrib_doc.get("wall_ms") or 0.0)
        if wall <= 0 or not corpus_bytes or corpus_bytes <= 0:
            return 0
        workloads = self.doc.setdefault("workloads", {})
        key = _workload_key(ident, workload)
        row = workloads.get(key)
        if row is None:
            row = workloads[key] = dict(
                ident, workload=workload, runs=0, corpus_bytes=0.0,
                wall_ms=0.0, unattributed_ms=0.0)
        row["runs"] += 1
        row["corpus_bytes"] += float(corpus_bytes)
        row["wall_ms"] += wall
        row["unattributed_ms"] += float(
            attrib_doc.get("unattributed_ms") or 0.0)
        for name, b in (attrib_doc.get("buckets") or {}).items():
            f = f"bucket_{name}_ms"
            row[f] = float(row.get(f, 0.0)) + float(b.get("ms") or 0.0)
        return 1

    # --- merge / persist --------------------------------------------------

    def merge_from(self, other: dict) -> None:
        """Fold another store DOCUMENT into this one (legacy comms keys
        normalized to the ``source``-tagged form, then validated)."""
        _normalize_legacy_comms(other)
        validate_doc(other)
        for section in ("comms", "programs", "workloads"):
            for key, row in (other.get(section) or {}).items():
                mine = self.doc.setdefault(section, {}).get(key)
                if mine is None:
                    self.doc[section][key] = dict(row)
                    continue
                for field, v in row.items():
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        mine.setdefault(field, v)
                    elif field in _COMM_IDENTITY or field == "device_count":
                        pass  # identity fields never accumulate
                    else:
                        mine[field] = mine.get(field, 0) + v
        self.doc["runs"] = (int(self.doc.get("runs") or 0)
                            + int(other.get("runs") or 0))

    def save_merged(self) -> str:
        """Atomic read-merge-write of ``self.path``: under an ``flock``
        on a sidecar lock file, re-read whatever is on disk now (another
        process may have merged since we loaded), fold it in, write
        temp+rename.  Refuses (raises :class:`CalibMismatch`) instead of
        overwriting an incompatible store."""
        if not self.path:
            raise ValueError("store has no path")
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        lock_path = self.path + ".lock"
        lock_fd = os.open(lock_path, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            try:
                import fcntl

                fcntl.flock(lock_fd, fcntl.LOCK_EX)
            except ImportError:  # pragma: no cover - non-POSIX
                pass
            try:
                with open(self.path) as f:
                    on_disk = json.load(f)
            except FileNotFoundError:
                on_disk = None
            except (OSError, ValueError) as e:
                raise CalibMismatch(
                    f"unreadable calibration store {self.path!r}: {e}"
                ) from e
            if on_disk is not None:
                # self.doc holds ONLY this run's rows (the Obs wiring
                # seeds an empty store for accumulation; the prior
                # history loaded at job start is a separate read-only
                # object), so on-disk + ours never double-counts — even
                # when another process merged between our load and now
                merged = CalibStore(path=self.path)
                merged.merge_from(on_disk)   # validates on_disk
                merged.merge_from(self.doc)
                self.doc = merged.doc
            self.doc["updated_unix_s"] = round(time.time(), 3)
            from map_oxidize_tpu_torch.obs import write_json_atomic

            write_json_atomic(self.path, self.doc)
        finally:
            os.close(lock_fd)
        return self.path

    # --- reporting --------------------------------------------------------

    def bandwidth_table(self) -> list[dict]:
        """Per-(identity, collective, program, shape-bucket) bandwidth
        rows, bytes-heaviest first.  ``gbytes_per_s`` needs sampled
        latency; rows without samples still carry calls/bytes."""
        rows = []
        for row in self.doc.get("comms", {}).values():
            calls = row.get("calls") or 0
            out = dict(row)
            if calls:
                out["bytes_per_call"] = row["bytes"] / calls
            samples = row.get("latency_samples") or 0
            if samples and row.get("latency_ms"):
                mean_ms = row["latency_ms"] / samples
                out["mean_latency_ms"] = round(mean_ms, 4)
                if calls:
                    out["gbytes_per_s"] = round(
                        (row["bytes"] / calls) / (mean_ms / 1e3) / 1e9, 4)
            rows.append(out)
        rows.sort(key=lambda r: -(r.get("bytes") or 0))
        return rows

    def program_table(self) -> list[dict]:
        rows = []
        for row in self.doc.get("programs", {}).values():
            out = dict(row)
            n = row.get("dispatches") or 0
            if n:
                out["dispatch_ms_per_call"] = round(
                    row["dispatch_ms"] / n, 4)
            s = row.get("compute_samples") or 0
            if s:
                out["compute_ms_per_sample"] = round(
                    row["compute_ms"] / s, 4)
            rows.append(out)
        rows.sort(key=lambda r: -(r.get("dispatch_ms") or 0))
        return rows


def validate_doc(doc: dict, path: str = "") -> None:
    """Schema/version/identity-consistency check; raises
    :class:`CalibMismatch` with the named reason."""
    where = f" ({path})" if path else ""
    if not isinstance(doc, dict) or doc.get("schema") != CALIB_SCHEMA:
        raise CalibMismatch(
            f"not a {CALIB_SCHEMA} store{where}: schema="
            f"{doc.get('schema') if isinstance(doc, dict) else type(doc)}")
    if doc.get("version") != CALIB_VERSION:
        raise CalibMismatch(
            f"calibration store version {doc.get('version')!r} != "
            f"supported {CALIB_VERSION}{where}; refusing to merge")
    for section, ident_fields in (("comms", _COMM_IDENTITY),
                                  ("programs", _PROG_IDENTITY),
                                  ("workloads", _WORKLOAD_IDENTITY)):
        for key, row in (doc.get(section) or {}).items():
            parts = key.split("|")
            if len(parts) != len(ident_fields):
                raise CalibMismatch(
                    f"malformed {section} key {key!r}{where}")
            for field, part in zip(ident_fields, parts):
                stored = row.get(field)
                if str(stored) != part:
                    raise CalibMismatch(
                        f"{section} row {key!r}: stored {field}="
                        f"{stored!r} disagrees with its key{where}; "
                        "refusing to merge a torn/doctored store")


# --- read-side curve APIs (the planner's substrate) ------------------------


def program_curve(store: "CalibStore | None", ident: dict,
                  program: str) -> dict | None:
    """The store's warm per-call figures for one program under this
    identity: ``dispatch_ms_per_call`` (the launch floor) and
    ``compute_ms_per_sample`` — the cross-process form of the compile
    ledger's in-memory measurements, what a COLD process plans auto-B
    from.  None when the store has no usable row."""
    if store is None:
        return None
    row = (store.doc.get("programs") or {}).get(_prog_key(ident, program))
    if not row:
        return None
    out: dict = {"runs": int(row.get("runs") or 0)}
    n = row.get("dispatches") or 0
    if n and row.get("dispatch_ms"):
        out["dispatch_ms_per_call"] = float(row["dispatch_ms"]) / n
    s = row.get("compute_samples") or 0
    if s and row.get("compute_ms"):
        out["compute_ms_per_sample"] = float(row["compute_ms"]) / s
    return out if len(out) > 1 else None


def workload_curve(store: "CalibStore | None", ident: dict,
                   workload: str) -> dict | None:
    """The store's per-MB wall rates for one workload under this
    identity: ``wall_ms_per_mb`` plus ``buckets_ms_per_mb`` in the SAME
    bucket names ``obs where`` attributes — the planner multiplies them
    by the new corpus's size for its predicted wall.  None when the
    store has no row with positive bytes and wall."""
    if store is None:
        return None
    row = (store.doc.get("workloads") or {}).get(
        _workload_key(ident, workload))
    if not row:
        return None
    mb = float(row.get("corpus_bytes") or 0.0) / (1 << 20)
    wall = float(row.get("wall_ms") or 0.0)
    if mb <= 0 or wall <= 0:
        return None
    runs = int(row.get("runs") or 1)
    curve = {
        "runs": runs,
        "wall_ms_per_mb": wall / mb,
        "mean_corpus_bytes": float(row["corpus_bytes"]) / max(runs, 1),
        "buckets_ms_per_mb": {},
    }
    for f, v in row.items():
        if f.startswith("bucket_") and f.endswith("_ms"):
            curve["buckets_ms_per_mb"][f[len("bucket_"):-len("_ms")]] = (
                float(v) / mb)
    return curve


def interpolate_latency_ms(store: "CalibStore | None", ident: dict,
                           collective: str, nbytes: float,
                           program: str | None = None) -> float | None:
    """Read-side interpolation over the per-shape-bucket latency curve:
    the expected one-call latency of ``collective`` at payload
    ``nbytes`` under this identity, log-linear in payload between the
    measured bucket means and clamped at the curve's ends (collective
    cost is near-affine in log-payload across the bucket range — the
    portable-collectives premise).  ``program=None`` pools rows across
    programs.  None when no sampled row matches."""
    if store is None:
        return None
    pts = []
    for row in (store.doc.get("comms") or {}).values():
        if (row.get("platform") != ident["platform"]
                or str(row.get("device_count")) != str(
                    ident["device_count"])
                or row.get("topology") != ident["topology"]
                or row.get("collective") != collective):
            continue
        if program is not None and row.get("program") != program:
            continue
        calls = row.get("calls") or 0
        samples = row.get("latency_samples") or 0
        if calls and samples and row.get("latency_ms"):
            pts.append((float(row["bytes"]) / calls,
                        float(row["latency_ms"]) / samples))
    if not pts:
        return None
    pts.sort()
    x = max(float(nbytes), 1.0)
    if x <= pts[0][0]:
        return pts[0][1]
    if x >= pts[-1][0]:
        return pts[-1][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if x0 <= x <= x1:
            if x1 <= x0:
                return y1
            t = ((math.log(x) - math.log(x0))
                 / (math.log(x1) - math.log(x0)))
            return y0 + t * (y1 - y0)
    return pts[-1][1]  # pragma: no cover - unreachable past the clamp


# --- the coverage plane (needs vs has) --------------------------------------


def bucket_index(label: str) -> int | None:
    """A shape-bucket label's power-of-two exponent (``"64KB"`` → 16),
    the x-axis the coverage distance is measured on.  None for
    unparsable or zero buckets."""
    if not isinstance(label, str) or not label:
        return None
    for suffix, scale in (("TB", 1 << 40), ("GB", 1 << 30),
                          ("MB", 1 << 20), ("KB", 1 << 10), ("B", 1)):
        if label.endswith(suffix):
            try:
                n = int(label[:-len(suffix)]) * scale
            except ValueError:
                return None
            return n.bit_length() - 1 if n > 0 else None
    return None


def collective_evidence(store: "CalibStore | None", ident: dict,
                        collective: str, bucket: str,
                        program: str | None = None) -> dict:
    """What the store KNOWS about one (collective, bucket) cell under
    this identity: sampled-latency counts in the exact bucket (total and
    split by evidence ``source`` — probe and job rows pool for density
    but stay attributable), plus ``bucket_distance`` — how many pow2
    steps the nearest sampled bucket is from the needed one (0 = exact
    hit; None = no sampled curve for this collective at all, i.e. a
    cold cell where even extrapolation has nothing to extrapolate
    from)."""
    want = bucket_index(bucket)
    samples = 0
    by_source: dict[str, int] = {}
    sampled: dict[str, int] = {}
    for row in ((store.doc.get("comms") or {}).values()
                if store is not None else ()):
        if (row.get("platform") != ident["platform"]
                or str(row.get("device_count")) != str(
                    ident["device_count"])
                or row.get("topology") != ident["topology"]
                or row.get("collective") != collective):
            continue
        if program is not None and row.get("program") != program:
            continue
        s = int(row.get("latency_samples") or 0)
        if s <= 0:
            continue
        b = row.get("shape_bucket")
        sampled[b] = sampled.get(b, 0) + s
        if b == bucket:
            samples += s
            src = row.get("source", "job")
            by_source[src] = by_source.get(src, 0) + s
    distance: int | None = None
    if want is not None:
        idxs = [i for i in (bucket_index(b) for b in sampled)
                if i is not None]
        if idxs:
            distance = min(abs(want - i) for i in idxs)
    return {
        "bucket": bucket, "samples": samples, "by_source": by_source,
        "bucket_distance": distance,
        "sampled_buckets": sorted(sampled, key=lambda b:
                                  bucket_index(b) or 0),
    }


def coverage_report(store: "CalibStore | None", ident: dict,
                    needed_cells: list[dict],
                    min_samples: int = CALIB_MIN_SAMPLES) -> dict:
    """Needs-vs-has over the planner's required (collective, program,
    bucket) cells: a cell is COVERED when the store holds at least
    ``min_samples`` sampled latencies in the exact bucket.
    ``coverage_pct`` is the covered fraction; ``extrapolation_bucket_
    distance`` the worst pow2-step gap the chooser would have to
    extrapolate across (cells with no curve at all are uncovered but
    excluded from the distance — there is nothing to extrapolate
    from)."""
    cells = []
    covered = 0
    distances = []
    for need in needed_cells:
        ev = collective_evidence(store, ident, need["collective"],
                                 need["bucket"],
                                 program=need.get("program"))
        ok = (ev["samples"] >= min_samples
              and ev["bucket_distance"] == 0)
        covered += int(ok)
        if ev["bucket_distance"] is not None:
            distances.append(ev["bucket_distance"])
        cells.append({
            "collective": need["collective"],
            "program": need.get("program"),
            "bucket": need["bucket"], "samples": ev["samples"],
            "by_source": ev["by_source"],
            "bucket_distance": ev["bucket_distance"], "covered": ok,
        })
    needed = len(cells)
    return {
        "schema": "moxt-calib-coverage-v1",
        "identity": dict(ident), "min_samples": int(min_samples),
        "needed": needed, "covered": covered,
        "coverage_pct": round(100.0 * covered / needed, 1) if needed
        else 100.0,
        "extrapolation_bucket_distance": max(distances) if distances
        else 0,
        "cells": cells,
    }


def render_coverage(report: dict) -> str:
    """Human-readable needs-vs-has table (`obs calib coverage`)."""
    ident = report.get("identity") or {}
    lines = [
        f"calibration coverage: {report['covered']}/{report['needed']} "
        f"cells covered ({report['coverage_pct']}%) under "
        f"{ident.get('platform')}/{ident.get('topology')} "
        f"(min {report['min_samples']} samples/cell); worst "
        f"extrapolation distance "
        f"{report['extrapolation_bucket_distance']} bucket(s)",
        f"  {'collective':<11} {'program':<26} {'bucket':>7} "
        f"{'samples':>8} {'dist':>5}  status",
    ]
    for c in report.get("cells") or []:
        srcs = ",".join(f"{k}:{v}" for k, v in
                        sorted((c.get("by_source") or {}).items()))
        dist = c["bucket_distance"]
        status = ("covered" if c["covered"] else
                  "no curve" if dist is None else
                  f"extrapolated ({dist} away)" if dist else
                  "thin evidence")
        lines.append(
            f"  {c['collective']:<11} {c.get('program') or '*':<26} "
            f"{c['bucket']:>7} {c['samples']:>8} "
            f"{'-' if dist is None else dist:>5}  {status}"
            + (f" [{srcs}]" if srcs else ""))
    return "\n".join(lines)


# --- rendering (the `obs calib` table) -------------------------------------


def render(store: CalibStore) -> str:
    """Human-readable store report: the bandwidth curves (grouped by
    identity + collective + program, one line per shape-bucket) and the
    per-program dispatch/compute table."""
    doc = store.doc
    lines = [f"calibration store: {doc.get('runs', 0)} runs merged"
             + (f", updated {time.strftime('%Y-%m-%dT%H:%M:%S', time.localtime(doc['updated_unix_s']))}"
                if doc.get("updated_unix_s") else "")]
    comms = store.bandwidth_table()
    if comms:
        lines.append("collective bandwidth (per shape bucket; rows with "
                     f"< {CALIB_MIN_SAMPLES} samples marked 'thin' — "
                     "below the selection floor):")
        by_source: dict[str, list] = {}
        for r in comms:
            by_source.setdefault(r.get("source", "job"), []).append(r)
        for src in sorted(by_source):
            lines.append(f" source={src}:")
            lines.append(f"  {'identity':<12} {'collective':<11} "
                         f"{'program':<24} {'bucket':>7} {'calls':>7} "
                         f"{'bytes':>9} {'smpl':>5} {'lat ms':>8} "
                         f"{'GB/s':>7}")
            for r in by_source[src]:
                ident = f"{r['platform']}/{r['topology']}"
                samples = int(r.get("latency_samples") or 0)
                thin = ("  thin" if 0 < samples < CALIB_MIN_SAMPLES
                        else "")
                lines.append(
                    f"  {ident:<12} {r['collective']:<11} "
                    f"{r['program']:<24} "
                    f"{r['shape_bucket']:>7} {r['calls']:>7} "
                    f"{_fmt_bytes(r['bytes']):>9} {samples:>5} "
                    f"{r.get('mean_latency_ms', '-'):>8} "
                    f"{r.get('gbytes_per_s', '-'):>7}{thin}")
    else:
        lines.append("no collective rows yet (runs with a multi-shard "
                     "mesh or multi-process exchange populate them)")
    progs = store.program_table()
    if progs:
        lines.append("program dispatch/compute:")
        lines.append(f"  {'identity':<12} {'program':<28} {'disp':>7} "
                     f"{'ms/disp':>8} {'compute ms':>10} {'compiles':>8}")
        for r in progs[:20]:
            ident = f"{r['platform']}/{r['topology']}"
            lines.append(
                f"  {ident:<12} {r['program']:<28} {r['dispatches']:>7} "
                f"{r.get('dispatch_ms_per_call', '-'):>8} "
                f"{r.get('compute_ms_per_sample', '-'):>10} "
                f"{r['compiles']:>8}")
    return "\n".join(lines)
