"""Map-output checkpointing: resumable jobs.

With ``checkpoint_dir`` set, every mapped chunk's ``MapOutput`` (key planes,
values, dictionary delta) is spilled atomically, and a re-run of the same
job replays the spilled prefix into the device engine instead of re-mapping
it, then resumes mapping at the recorded byte offset.  k-means keeps one
snapshot of its centroids per iteration instead.

The on-disk format is the JAX package's (format version 1, the same
``job_meta`` identity keys and no key naming the framework), so a spill
written by either package replays in the other.  Layout under
``checkpoint_dir``:

* ``meta.json`` — job identity (input path/size/mtime, chunk_bytes, workload,
  tokenizer).  A mismatch invalidates the checkpoint (it is discarded and the
  job starts fresh) — resuming someone else's intermediates must be
  impossible.
* ``chunk_{i:06d}.npz`` — one per mapped chunk, written to a temp name and
  renamed, so a killed run can never leave a torn chunk file.  Carries
  ``next_offset``: the input byte offset after this chunk, which is a valid
  restart point by the splitter/native cut contract (both cut at the same
  whitespace boundaries).
* ``snapshot.npz`` — an engine-state or k-means snapshot, superseded by
  each save.

Only the **contiguous** prefix ``chunk_0 .. chunk_{k-1}`` is replayed; later
files (possible when threaded map completes out of order) are discarded and
re-mapped.  Replayed dictionary deltas are queued as columnar arrays and
collision-checked at the dictionary's first materialization (finalize).

``keep_intermediates=True`` preserves the directory after success (a
failure to delete is a warning).
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import zipfile

import numpy as np

from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.ops.hashing import HashDictionary
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

_FORMAT_VERSION = 1


def _arrays_to_dict(hashes, lens, blob) -> HashDictionary:
    d = HashDictionary()
    d.add_arrays(np.asarray(hashes, np.uint64), np.asarray(lens, np.int64),
                 blob.tobytes())
    return d


class CheckpointStore:
    """Spill/replay of per-chunk map outputs under one directory."""

    def __init__(self, directory: str, meta: dict, registry=None):
        self.dir = directory
        self.meta = dict(meta, version=_FORMAT_VERSION)
        #: optional counter sink with a ``count(name, n=1)`` method
        self.registry = registry
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")
        existing = self._read_meta()
        if existing is not None and existing != self.meta:
            _log.warning(
                "checkpoint at %s is for a different job "
                "(have %s, want %s); discarding it", self.dir, existing,
                self.meta)
            self._clear_chunks(strict=True)
            existing = None
        if existing is None:
            self._clear_chunks(strict=True)
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.meta, f, sort_keys=True)
            os.replace(tmp, self._meta_path)

    @staticmethod
    def job_meta(config, workload: str, hash_only: bool = False,
                 extra: dict | None = None) -> dict:
        """The identity key a checkpoint must match to be resumable.

        ``hash_only`` is part of the identity because it changes the SPILL
        FORMAT: hash-only chunks carry no dictionary strings, so replaying
        them into a string-draining run would finalize with missing words.
        ``extra`` merges path-specific identity keys (k-means: k, mode,
        shards, backend, precision, initial centroids)."""
        st = os.stat(config.input_path)
        meta = {
            "input_path": os.path.abspath(config.input_path),
            "input_size": st.st_size,
            "input_mtime_ns": st.st_mtime_ns,
            "chunk_bytes": config.chunk_bytes,
            "num_chunks": config.num_chunks,
            "workload": workload,
            "tokenizer": config.tokenizer,
            "hash_only": bool(hash_only),
        }
        if extra:
            meta.update(extra)
        return meta

    def _read_meta(self) -> dict | None:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"chunk_{idx:06d}.npz")

    @property
    def _snapshot_path(self) -> str:
        return os.path.join(self.dir, "snapshot.npz")

    def _clear_chunks(self, strict: bool = False) -> None:
        """Remove all checkpoint artifacts.  ``strict`` raises if a stale
        chunk file survives — required when invalidating another job's spill,
        where a leftover chunk would later replay as if it were ours."""
        failed = []
        for name in os.listdir(self.dir):
            if (name.startswith("chunk_") or name.startswith("meta.json")
                    or name.startswith("snapshot") or name.endswith(".tmp")):
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError as e:
                    failed.append((name, e))
        if failed and strict:
            raise RuntimeError(
                f"cannot invalidate stale checkpoint in {self.dir}: "
                f"{failed[0][1]} (and {len(failed) - 1} more); remove the "
                "directory manually or choose another checkpoint_dir")

    def _count(self, name: str, n: int = 1) -> None:
        if self.registry is not None:
            self.registry.count(name, n)

    def _write_atomic(self, path: str, payload: dict) -> None:
        """``np.savez`` to a temp file, fsync, rename: a process crash never
        leaves a torn file under the real name, and the fsync before the
        rename keeps a renamed-but-unwritten file from surviving a power
        loss (rename-before-data is a real ext4 ordering)."""
        fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=self.dir)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # --- spill ----------------------------------------------------------

    def save(self, idx: int, out: MapOutput, next_offset: int) -> None:
        """Atomically persist one mapped chunk; replay() treats an
        unloadable chunk as the end of the contiguous prefix."""
        out.ensure_planes()  # compact keys64-only outputs spill as planes
        hashes, lens, blob = out.dictionary.to_arrays()
        path = self._chunk_path(idx)
        self._write_atomic(path, dict(
            hi=out.hi, lo=out.lo, values=out.values,
            records_in=np.int64(out.records_in),
            next_offset=np.int64(next_offset),
            dict_hashes=hashes, dict_lens=lens, dict_blob=blob))
        self._count("checkpoint/chunks_saved")
        if self.registry is not None:
            try:
                self._count("checkpoint/bytes_saved", os.path.getsize(path))
            except OSError:
                pass

    # --- snapshots (k-means, device-map paths) --------------------------
    #
    # A path that never holds map outputs on the host keeps a SNAPSHOT of
    # its reduced state (engine planes or centroids + dictionary + input
    # offset) instead of the per-chunk spill.  One file, atomically
    # replaced; each save supersedes the last.

    def save_snapshot(self, state: dict, dictionary, offset: int,
                      n_chunks: int, extra: dict | None = None) -> None:
        hashes, lens, blob = dictionary.to_arrays()
        payload = {f"eng_{k}": v for k, v in state.items()}
        payload.update(offset=np.int64(offset), n_chunks=np.int64(n_chunks),
                       dict_hashes=hashes, dict_lens=lens, dict_blob=blob)
        for k, v in (extra or {}).items():
            payload[f"x_{k}"] = v
        self._write_atomic(self._snapshot_path, payload)
        self._count("checkpoint/snapshots_saved")

    def load_snapshot(self):
        """Return ``(engine_state, dictionary, offset, n_chunks, extra)`` or
        None.  A corrupt snapshot (power loss) is discarded — the job simply
        starts fresh."""
        try:
            with np.load(self._snapshot_path) as z:
                state = {k[4:]: z[k] for k in z.files if k.startswith("eng_")}
                extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
                d = _arrays_to_dict(z["dict_hashes"], z["dict_lens"],
                                    z["dict_blob"])
                return (state, d, int(z["offset"]), int(z["n_chunks"]),
                        extra)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, struct.error) as e:
            _log.warning("snapshot unreadable (%s); starting fresh", e)
            try:
                os.unlink(self._snapshot_path)
            except OSError:
                pass
            return None

    # --- replay ---------------------------------------------------------

    def saved_prefix(self) -> int:
        """Number of chunks in the contiguous saved prefix (0 = nothing)."""
        k = 0
        while os.path.isfile(self._chunk_path(k)):
            k += 1
        return k

    def replay(self):
        """Yield ``(idx, MapOutput, next_offset)`` for the contiguous prefix;
        stale out-of-order leftovers beyond it are deleted (they will be
        re-mapped, so keeping them could only confuse a later resume)."""
        k = self.saved_prefix()
        for name in os.listdir(self.dir):
            if name.startswith("chunk_") and name.endswith(".npz"):
                try:
                    idx = int(name[6:12])
                except ValueError:
                    continue
                if idx >= k:
                    os.unlink(os.path.join(self.dir, name))
        for idx in range(k):
            try:
                with np.load(self._chunk_path(idx)) as z:
                    out = MapOutput(
                        hi=z["hi"], lo=z["lo"], values=z["values"],
                        dictionary=_arrays_to_dict(
                            z["dict_hashes"], z["dict_lens"], z["dict_blob"]),
                        records_in=int(z["records_in"]),
                    )
                    item = (idx, out, int(z["next_offset"]))
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, struct.error) as e:
                # a corrupt chunk (e.g. power loss wrote the name but not the
                # data) ends the usable prefix: drop it and everything after
                # — those ranges simply re-map
                _log.warning("checkpoint chunk %d unreadable (%s); resuming "
                             "from chunk %d and re-mapping the rest", idx, e,
                             idx)
                for j in range(idx, k):
                    try:
                        os.unlink(self._chunk_path(j))
                    except OSError:
                        pass
                return
            self._count("checkpoint/chunks_replayed")
            yield item

    # --- lifecycle ------------------------------------------------------

    def finish(self, keep: bool) -> None:
        """On job success: delete the spill unless ``keep_intermediates``.
        Deletion failures warn and continue."""
        if keep:
            _log.info("keeping %d checkpoint chunks in %s",
                      self.saved_prefix(), self.dir)
            return
        try:
            self._clear_chunks()
            os.rmdir(self.dir)
        except OSError as e:
            _log.warning("could not remove checkpoint dir %s: %s", self.dir, e)
