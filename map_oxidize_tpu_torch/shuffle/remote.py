"""Remote-staged transport: shuffle partitions that outlive a worker.
The port of the JAX package's ``shuffle/remote.py`` (whole); its files are
byte-compatible with the JAX package's, so each package reads a stage the
other wrote.

Placement-wise :class:`RemoteTransport` is ``disk`` (SPILLED from the first
row; single-controller engines stage through the same top-bits bucket
machinery).  What this module adds is the multi-process stage on a shared
filesystem, from which a surviving peer can finish a job after a process
dies mid-shuffle.

**Object layout** (``<stage-root>/``)::

    proc<p>/part<q>.rows      append-only 16-byte (u64 key, i64 value)
                              records owned by partition q (key % P == q)
    proc<p>/strings.dat       append-only (u64 hash, u32 len, bytes)
                              records resolving this process's keys
    manifest.proc<p>.json     the commit record (schema below)
    claim.proc<d>             O_CREAT|O_EXCL takeover claim for a dead
                              peer d (exactly one survivor wins)
    proc<d>.rec<p>/...        claimant p's re-map of dead peer d's
                              un-committed chunks
    manifest.proc<d>.rec.json the recovery commit record

**Manifest** (``moxt-shuffle-stage-v1``): written via write-tmp +
``os.replace`` after every committed chunk, so the visible manifest is
always internally consistent: data files are append-only and the manifest
records the VALID ROW PREFIX per object, so a process SIGKILLed
mid-append leaves a readable stage::

    {"schema": "moxt-shuffle-stage-v1", "proc": p, "n_proc": P,
     "final": false, "chunks_done": [...global chunk indices...],
     "records": n, "strings_rows": s,
     "objects": [{"file": "proc0/part1.rows", "part": 1, "rows": r}],
     "checksums": {"1": wsum}}    # per-partition sum(mix64(k)*v) mod 2^64

The per-partition checksums prove conservation without collectives: the
drain-side weighted checksum of partition q must equal the u64-wrapping
sum of every manifest's ``checksums[q]``.

**Recovery contract**: a peer that never writes its ``final: true``
manifest within the deadline is claimed (:func:`claim_dead_proc`) by
exactly one survivor, which re-maps the dead peer's chunks NOT in its last
committed ``chunks_done`` (ownership is deterministic: index % P) and
writes the dead peer's output partition from the staged objects."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from map_oxidize_tpu_torch.shuffle.base import ShuffleTransport
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

STAGE_SCHEMA = "moxt-shuffle-stage-v1"

#: one staged row: the key and its (possibly pre-combined) partial value
REC = np.dtype([("k", "<u8"), ("v", "<i8")])

#: one strings-table row header: u64 key hash, u32 token byte length
_STR_HDR = np.dtype([("h", "<u8"), ("n", "<u4")])


class RemoteTransport(ShuffleTransport):
    """SPILLED from the start, like disk — but the stage is the shared
    filesystem object layout above, not process-private buckets."""

    name = "remote"

    def __init__(self) -> None:
        super().__init__()
        self.spilled_state = True

    def admit(self, resident_rows: int, max_rows: int, engine: str) -> str:
        return "spill"


def stage_root(config) -> str:
    """The stage directory for one job: ``remote_stage_dir`` when set,
    else derived from the output path (the one location every process
    of a shared-filesystem job can already reach)."""
    root = getattr(config, "remote_stage_dir", "") or ""
    if root:
        return root
    out = getattr(config, "output_path", "") or "moxt_remote"
    return out + ".stage"


def manifest_path(root: str, proc: int) -> str:
    return os.path.join(root, f"manifest.proc{proc}.json")


def recovery_manifest_path(root: str, proc: int) -> str:
    """The claimant-committed manifest covering a dead ``proc``'s
    re-mapped chunks (the dead peer's own last manifest stays in place
    and keeps covering its committed prefix)."""
    return os.path.join(root, f"manifest.proc{proc}.rec.json")


def read_manifest(root: str, proc: int,
                  recovery: bool = False) -> "dict | None":
    """The last atomically committed manifest for ``proc`` (None when
    the process died before its first commit)."""
    path = (recovery_manifest_path(root, proc) if recovery
            else manifest_path(root, proc))
    try:
        with open(path, "rb") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != STAGE_SCHEMA:
        raise ValueError(
            f"stage manifest {path} has schema "
            f"{doc.get('schema')!r}, expected {STAGE_SCHEMA!r}")
    return doc


class RemoteStage:
    """One process's writer half of the stage: partition, append,
    commit.  ``append_chunk`` is the atom — rows land in the per-
    partition object files, then ONE manifest replace commits the chunk
    (a kill between the two leaves the previous manifest authoritative
    and the appended tail invisible)."""

    def __init__(self, root: str, proc: int, n_proc: int, obs=None,
                 owner: "int | None" = None):
        #: ``owner`` is the process whose CHUNKS these rows come from —
        #: a survivor re-mapping a dead peer writes with owner=dead.
        #: Recovery NEVER touches the dead peer's files (its committed
        #: prefix stays authoritative; its torn tail stays dead weight):
        #: it writes a fresh ``proc<d>.rec<p>/`` directory and commits a
        #: separate ``manifest.proc<d>.rec.json``, and readers simply sum
        #: over every committed manifest.
        self.root = root
        self.proc = proc
        self.owner = proc if owner is None else owner
        self.n_proc = n_proc
        self.obs = obs
        self.dir_name = (f"proc{self.owner}" if self.owner == proc
                         else f"proc{self.owner}.rec{proc}")
        self.dir = os.path.join(root, self.dir_name)
        os.makedirs(self.dir, exist_ok=True)
        self.chunks_done: list[int] = []
        self.records = 0
        self.strings_rows = 0
        self._rows = np.zeros(n_proc, np.int64)
        self._wsum = np.zeros(n_proc, np.uint64)
        self._files: dict[int, object] = {}

    def _part_file(self, q: int):
        f = self._files.get(q)
        if f is None:
            f = open(os.path.join(self.dir, f"part{q}.rows"), "ab")
            self._files[q] = f
        return f

    def append_chunk(self, chunk_index: int, keys: np.ndarray,
                     vals: np.ndarray, records: int = 0) -> None:
        """Partition one mapped (and usually pre-combined) chunk by
        ``key % P``, append each partition's records, fsync, and commit
        the chunk with a manifest replace."""
        from map_oxidize_tpu_torch.obs.dataplane import mix64

        keys = np.ascontiguousarray(keys, np.uint64)
        vals = np.ascontiguousarray(vals, np.int64)
        part = (keys % np.uint64(self.n_proc)).astype(np.int64)
        w = mix64(keys) * vals.view(np.uint64)
        nbytes = 0
        for q in np.unique(part).tolist():
            sel = part == q
            rec = np.empty(int(sel.sum()), REC)
            rec["k"] = keys[sel]
            rec["v"] = vals[sel]
            f = self._part_file(q)
            f.write(rec.tobytes())
            f.flush()
            os.fsync(f.fileno())
            self._rows[q] += rec.shape[0]
            with np.errstate(over="ignore"):  # mod-2^64 by design
                self._wsum[q] += w[sel].sum(dtype=np.uint64)
            nbytes += rec.nbytes
        self.chunks_done.append(int(chunk_index))
        self.records += int(records)
        if self.obs is not None:
            reg = self.obs.registry
            reg.count("shuffle/remote_rows", int(keys.shape[0]))
            reg.count("shuffle/remote_bytes", nbytes)
            reg.count("shuffle/remote_chunks")
        self._commit(final=False)

    def stage_strings(self, dictionary) -> None:
        """Append this process's hash -> token-bytes resolutions (every
        key it mapped), so ANY survivor can render winners for ANY
        partition without a gather collective."""
        items = list(dictionary.items())
        if not items:
            return
        with open(os.path.join(self.dir, "strings.dat"), "ab") as f:
            for h, tok in items:
                hdr = np.zeros(1, _STR_HDR)
                hdr["h"] = np.uint64(h)
                hdr["n"] = np.uint32(len(tok))
                f.write(hdr.tobytes())
                f.write(tok)
            f.flush()
            os.fsync(f.fileno())
        self.strings_rows += len(items)

    def finish(self) -> None:
        """The final commit: ``final: true`` tells waiting peers this
        process staged everything it owns."""
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._commit(final=True)

    def _commit(self, final: bool) -> None:
        doc = {
            "schema": STAGE_SCHEMA,
            "proc": self.owner,
            "staged_by": self.proc,
            "n_proc": self.n_proc,
            "final": final,
            "chunks_done": self.chunks_done,
            "records": self.records,
            "strings_rows": self.strings_rows,
            "objects": [
                {"file": f"{self.dir_name}/part{q}.rows", "part": q,
                 "rows": int(self._rows[q])}
                for q in range(self.n_proc) if self._rows[q]
            ],
            "checksums": {str(q): int(self._wsum[q])
                          for q in range(self.n_proc) if self._rows[q]},
        }
        target = (manifest_path(self.root, self.owner)
                  if self.owner == self.proc
                  else recovery_manifest_path(self.root, self.owner))
        tmp = target + f".tmp{self.proc}"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)


def wait_for_finals(root: str, n_proc: int, self_proc: int,
                    timeout_s: float, poll_s: float = 0.25,
                    ) -> "tuple[dict, list[int]]":
    """Poll peers' manifests until every one is ``final`` or the
    deadline passes.  Returns ``(manifests_by_proc, dead_procs)`` —
    ``dead`` lists peers with no final manifest at the deadline (their
    LAST committed manifest, possibly None, still rides in the dict)."""
    deadline = time.monotonic() + max(timeout_s, 0.0)
    manifests: dict = {}
    while True:
        pending = []
        for p in range(n_proc):
            if p == self_proc:
                continue
            m = read_manifest(root, p)
            if m is not None:
                manifests[p] = m
            if m is None or not m.get("final"):
                pending.append(p)
        if not pending:
            return manifests, []
        if time.monotonic() >= deadline:
            _log.warning(
                "remote stage: peers %s never went final within %.1fs; "
                "declaring them dead and taking over from the manifest",
                pending, timeout_s)
            return manifests, pending
        time.sleep(poll_s)


def claim_dead_proc(root: str, dead: int, claimant: int) -> bool:
    """Exactly-one-survivor takeover: O_CREAT|O_EXCL on the claim file.
    The winner re-maps the dead peer's un-staged chunks and writes its
    output partition; losers treat the partition as handled."""
    try:
        fd = os.open(os.path.join(root, f"claim.proc{dead}"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.write(fd, f"{claimant}\n".encode())
    os.close(fd)
    return True


def read_partition(root: str, manifests: "dict[int, dict]", part: int,
                   ) -> "tuple[np.ndarray, np.ndarray, int]":
    """Drain partition ``part`` across every committed manifest: the
    valid row prefix of each owning object file, concatenated, plus the
    manifest-summed expected checksum (u64 wrap) for the conservation
    audit.  Chunk dedup is the manifests' job (an owner's committed
    chunks are excluded from its claimant's re-map), so a plain
    concatenation here is exact."""
    keys: list[np.ndarray] = []
    vals: list[np.ndarray] = []
    want = np.uint64(0)
    for m in manifests.values():
        if m is None:
            continue
        for ob in m.get("objects", ()):
            if ob["part"] != part or not ob["rows"]:
                continue
            path = os.path.join(root, ob["file"])
            rec = np.fromfile(path, REC, count=int(ob["rows"]))
            if rec.shape[0] != ob["rows"]:
                raise ValueError(
                    f"stage object {path} holds {rec.shape[0]} rows but "
                    f"its manifest committed {ob['rows']}")
            keys.append(rec["k"].copy())
            vals.append(rec["v"].copy())
        with np.errstate(over="ignore"):  # mod-2^64 by design
            want += np.uint64(int(m.get("checksums", {}).get(str(part), 0)))
    if not keys:
        return (np.empty(0, np.uint64), np.empty(0, np.int64), int(want))
    return np.concatenate(keys), np.concatenate(vals), int(want)


def read_strings(root: str) -> "dict[int, bytes]":
    """Merge every staged strings table — live peers' AND recovery
    directories' — into one hash -> bytes dict (collisions impossible:
    same 64-bit hash discipline as
    :class:`~map_oxidize_tpu_torch.ops.hashing.HashDictionary`)."""
    import glob as _glob

    words: dict[int, bytes] = {}
    for path in sorted(
            _glob.glob(os.path.join(root, "proc*", "strings.dat"))):
        try:
            blob = open(path, "rb").read()
        except OSError:
            continue
        off = 0
        while off + _STR_HDR.itemsize <= len(blob):
            hdr = np.frombuffer(blob, _STR_HDR, count=1, offset=off)
            n = int(hdr["n"][0])
            off += _STR_HDR.itemsize
            if off + n > len(blob):
                break  # torn tail from a mid-append kill: dead weight
            words[int(hdr["h"][0])] = blob[off:off + n]
            off += n
    return words
