"""The device map's hash -> token-bytes dictionary, kept in native code.

The card hands the host each chunk's unique keys as 64-bit hashes with the
offset of one occurrence of each (its "rep"); the dictionary needs each
key's bytes.  :class:`NativeDictionary` builds it with one C++ call per
chunk (``csrc/device_dict.cpp``): the key at each rep is scanned as
:func:`~map_oxidize_tpu_torch.ops.device_tokenize.ngram_at` scans it, then
one probe of a persistent open-addressing table either inserts it or
compares its bytes with the stored key's, so a 64-bit hash collision raises
the ``ValueError`` that :class:`~map_oxidize_tpu_torch.ops.hashing.
HashDictionary` raises.  It answers the calls the device map's callers make
of a ``HashDictionary``; the Python ``{hash: bytes}`` map is built once, at
the first :meth:`NativeDictionary.materialized`, under the span
``device_map/materialize`` (counter ``device_map/materialize_ms``).  The
job's ``final_result.txt`` needs no such map: :meth:`NativeDictionary.
write_counts` looks up, sorts, formats and writes the readback's rows in
one native call (span ``device_map/write``, counter
``device_map/write_rows``).

The source is compiled with g++ on first use by the native map's build
helpers (:mod:`map_oxidize_tpu_torch.native.build`): the same flags, a
library name that digests the source, the command and ``-march=native``'s
target, and a failed build raises.  ctypes releases the GIL around each
call.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import numpy as np

from map_oxidize_tpu_torch.native import build as native_build
from map_oxidize_tpu_torch.ops.device_tokenize import ngram_at
from map_oxidize_tpu_torch.ops.hashing import HashDictionary

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "device_dict.cpp")
_STEM = "libmoxt_device_dict"

#: the native calls' return codes past a count
_COLLISION, _NO_MEMORY, _MISSING, _DUPLICATE, _IO_ERROR = -1, -2, -3, -4, -5


def library_path() -> str:
    return native_build.library_path(_SRC, _STEM)


def _compile(force: bool = False) -> str:
    return native_build._compile(force, _SRC, _STEM)


_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The library, built first if needed (one ``CDLL`` per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            for name, restype, argtypes in (
                    ("dd_new", p, []),
                    ("dd_free", None, [p]),
                    ("dd_len", i64, [p]),
                    ("dd_bytes", i64, [p]),
                    ("dd_add_chunk", i64, [p, p, i64, p, p, p, i64, i32, p]),
                    ("dd_add_arrays", i64, [p, p, p, p, i64, p]),
                    ("dd_export", None, [p, p, p, p, i32]),
                    ("dd_find", p, [p, ctypes.c_uint64, p]),
                    ("dd_write_counts", i64, [p, p, p, i64, i32, p])):
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint32)


class NativeDictionary:
    """Hash -> key-bytes dictionary of the device map, in C++.

    Every key is collision-checked once, in native code, as it arrives
    (:meth:`add_chunk`, :meth:`update`).  Not thread-safe: one per
    device-map job, which adds every shard's chunks to it on its one
    thread, so no dictionary is ever unioned with another.  ``obs``, when
    given, times the one materialization."""

    def __init__(self, obs=None):
        self._lib = _load_lib()
        self._st = self._lib.dd_new()
        if not self._st:
            raise MemoryError("device dictionary: allocation failed")
        self._obs = obs
        self._mat: dict[int, bytes] | None = None

    def close(self) -> None:
        if self._st:
            self._lib.dd_free(self._st)
            self._st = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        return int(self._lib.dd_len(self._st))

    def upper_bound(self) -> int:
        """Distinct keys <= this (exact here: nothing is pending)."""
        return len(self)

    def _check(self, rc: int, collision) -> int:
        """``rc`` of an insert: the new keys' count, or the error it
        names (``collision()`` gives the colliding hash and key)."""
        if rc >= 0:
            if rc:
                self._mat = None
            return rc
        if rc == _COLLISION:
            h, token = collision()
            raise ValueError(
                f"64-bit hash collision: {self.lookup(h)!r} and {token!r} "
                f"both hash to {h:#x}")
        raise MemoryError("device dictionary: allocation failed")

    def add_chunk(self, chunk, hi, lo, rep, ngram: int) -> int:
        """Add one chunk's keys: key ``i`` hashes to ``hi[i] << 32 |
        lo[i]`` and occurs at ``chunk[rep[i]:]`` (bytes or a view of
        them).  Returns how many keys were new."""
        view = np.frombuffer(chunk, np.uint8)
        hi, lo, rep = _u32(hi), _u32(lo), _u32(rep)
        n = hi.shape[0]
        if lo.shape[0] != n or rep.shape[0] != n:
            raise ValueError("hi, lo and rep differ in length")
        info = np.zeros(4, np.int64)
        rc = self._lib.dd_add_chunk(
            self._st, view.ctypes.data, view.size, hi.ctypes.data,
            lo.ctypes.data, rep.ctypes.data, n, ngram, info.ctypes.data)
        return self._check(rc, lambda: (
            int(info[3]) & 0xFFFFFFFFFFFFFFFF,
            ngram_at(chunk, int(info[2]), ngram)))

    def _add_arrays(self, hashes, lens, blob) -> int:
        hashes = np.ascontiguousarray(hashes, np.uint64)
        lens = np.ascontiguousarray(lens, np.int64)
        blob = np.frombuffer(blob, np.uint8)
        if (lens.shape[0] != hashes.shape[0] or (lens < 0).any()
                or lens.sum() != blob.size):
            raise ValueError("dictionary columns differ in length")
        info = np.zeros(4, np.int64)
        rc = self._lib.dd_add_arrays(
            self._st, hashes.ctypes.data, lens.ctypes.data,
            blob.ctypes.data, hashes.shape[0], info.ctypes.data)

        def collision():
            i = int(info[0])
            start = int(lens[:i].sum())
            return int(hashes[i]), blob[start:start + lens[i]].tobytes()
        return self._check(rc, collision)

    def update(self, other: "NativeDictionary | HashDictionary") -> None:
        """Add every entry of ``other`` (a restored snapshot's
        dictionary), each checked."""
        self._add_arrays(*other.to_arrays())

    def _export(self, sep: int = -1):
        n = len(self)
        hashes = np.empty(n, np.uint64)
        lens = np.empty(n, np.int64)
        size = int(self._lib.dd_bytes(self._st)) + (n if sep >= 0 else 0)
        blob = np.empty(size, np.uint8)
        if n:
            self._lib.dd_export(self._st, hashes.ctypes.data,
                                lens.ctypes.data, blob.ctypes.data, sep)
        return hashes, lens, blob

    def to_arrays(self):
        """All entries in insertion order as ``(hashes u64, lens i64,
        blob u8)`` columns, the snapshot's format."""
        return self._export()

    def materialized(self) -> dict[int, bytes]:
        """The hash -> bytes dict, built on the first call (read-only by
        convention)."""
        if self._mat is None:
            step = (self._obs.step("device_map/materialize", keys=len(self))
                    if self._obs is not None else contextlib.nullcontext())
            with step:
                # the keys one to a line, cut by bytes.split: the 1e6 key
                # objects ~2.5x as fast as slices by length.  A key never
                # holds whitespace but the one space between n-gram members
                hashes, _, blob = self._export(sep=ord("\n"))
                keys = blob.tobytes().split(b"\n")[:-1]
                if len(keys) != len(hashes):
                    raise ValueError("device dictionary: a key holds a "
                                     "newline")
                self._mat = dict(zip(hashes.tolist(), keys))
        return self._mat

    def items(self):
        return self.materialized().items()

    def write_counts(self, k64: np.ndarray, vals: np.ndarray, fd: int) -> int:
        """Write ``final_result.txt``'s rows to the open file ``fd``: the
        word under each hash of ``k64`` and its count in ``vals``, sorted
        by word, ``"{word} {count}\\n"`` each, the bytes that
        :func:`~map_oxidize_tpu_torch.io.writer.write_final_result` writes
        from Python.  Returns the rows written.  A hash not in the
        dictionary raises ``KeyError``, two hashes of one word
        ``RuntimeError``."""
        hashes = np.ascontiguousarray(k64, np.uint64)
        vals = np.ascontiguousarray(vals, np.int64)
        n = hashes.shape[0]
        if vals.shape != (n,):
            raise ValueError("hashes and counts differ in length")
        info = np.zeros(1, np.int64)
        step = (self._obs.step("device_map/write", rows=n)
                if self._obs is not None else contextlib.nullcontext())
        with step:
            rc = self._lib.dd_write_counts(
                self._st, hashes.ctypes.data, vals.ctypes.data, n, fd,
                info.ctypes.data)
        if rc == _MISSING:
            raise KeyError(int(hashes[info[0]]))
        if rc == _DUPLICATE:
            raise RuntimeError(f"readback found {int(info[0])} distinct "
                               f"words for {n} live keys")
        if rc == _IO_ERROR:
            raise OSError(int(info[0]), os.strerror(int(info[0])))
        if rc < 0:
            raise MemoryError("device dictionary: allocation failed")
        if self._obs is not None:
            self._obs.registry.count("device_map/write_rows", rc)
        return rc

    def get(self, h: int, default: bytes | None = None) -> bytes | None:
        if self._mat is not None:
            return self._mat.get(h, default)
        n = ctypes.c_int64()
        ptr = self._lib.dd_find(self._st, h, ctypes.byref(n))
        return default if ptr is None else ctypes.string_at(ptr, n.value)

    def lookup(self, h: int) -> bytes:
        tok = self.get(h)
        if tok is None:
            raise KeyError(h)
        return tok
