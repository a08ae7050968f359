"""Build + ctypes bindings for the native map hot loop.

``csrc/moxt_native.cpp`` is the JAX package's C++ source, code and C ABI
unchanged, so the two libraries can be held against each other bit for bit.
It is compiled on first use with g++ into ``map_oxidize_tpu_torch/_build/``
and loaded with ctypes.  The library's file name carries a digest of the
source, the compiler command and what ``-march=native`` resolves to on this
host, so an edited source never loads a stale build and a library built for
another CPU is never loaded; the name differs from the JAX package's
``libmoxt_native.so``, so both load side by side in one process.  The C call runs with the GIL released —
ctypes drops it for foreign calls — so host IO and device dispatch proceed
while a chunk maps.

Two wrapper flavours over the same stateful C API (``moxt_new`` /
``moxt_map`` / ``moxt_chunk_read`` / ``moxt_dict_read``):

* :class:`NativeStream` — one persistent state per workload instance.  The
  hash->bytes dictionary lives in C++ across chunks and each ``map_chunk``
  drains only the *delta* of newly seen keys, so steady-state chunks hand
  back (hash, count) arrays and ~no strings.
* :class:`NativeMapper` — the stateless per-call facade (fresh state each
  call) used by parity tests and one-shot callers.

Only the word-count entry points are bound; the doc-pair, hash-only, HLL
and sort helpers of the C source wait for the workloads that use them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from map_oxidize_tpu_torch.api import MapOutput
from map_oxidize_tpu_torch.ops.hashing import HashDictionary, split_u64
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "moxt_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
#: the C++ compiler
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


_targets: dict[str, bytes] = {}


def _target() -> bytes:
    """What ``-march=native`` resolves to here (``-Q --help=target``: the
    CPU and every instruction-set flag), once per compiler and process;
    raises as a failed build when the compiler cannot run."""
    if CXX not in _targets:
        try:
            _targets[CXX] = subprocess.run(
                [CXX, "-march=native", "-Q", "--help=target"], check=True,
                capture_output=True).stdout
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"native build failed: {e.stderr.decode()}") from e
        except OSError as e:  # no compiler at that path
            raise RuntimeError(f"native build failed: {e}") from e
    return _targets[CXX]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(
        src + " ".join((CXX, *CXX_FLAGS)).encode() + _target()).hexdigest()
    return os.path.join(BUILD_DIR, f"libmoxt_native_port-{digest[:16]}.so")


def _compile(force: bool = False) -> str:
    """Build the library unless a current one exists (always, with
    ``force``); raises with the compiler's output when the build fails."""
    so = library_path()
    if os.path.isfile(so) and not force:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temp name + atomic rename so concurrent builders are safe
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([CXX, *CXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e.stderr}") from e
    except OSError as e:  # no compiler at that path
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e}") from e
    os.replace(tmp, so)
    _log.info("built native map library: %s", so)
    return so


_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The library, built first if needed (one ``CDLL`` per process)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_compile())
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for name, restype, argtypes in (
                ("moxt_new", p, [i32]),
                ("moxt_free", None, [p]),
                ("moxt_map", i32, [p, p, i64]),
                ("moxt_set_unicode", i32,
                 [p, p, i64, p, p, p, i64, p, i64, p, i64]),
                ("moxt_chunk_unique", i64, [p]),
                ("moxt_chunk_tokens", i64, [p]),
                ("moxt_chunk_read", None, [p, p, p]),
                ("moxt_dict_pending", None, [p, p, p]),
                ("moxt_dict_read", None, [p, p, p, p]),
                ("moxt_file_open", p, [ctypes.c_char_p]),
                ("moxt_file_close", None, [p]),
                ("moxt_file_size", i64, [p]),
                ("moxt_map_range", i64, [p, p, i64, i64])):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _raise_map_error(rc: int) -> None:
    """Map a native return code to the same exception type the Python map
    raises for that condition."""
    if rc == 0:
        return
    if rc == 1:
        raise ValueError("64-bit hash collision in native map")
    if rc == 3:
        raise UnicodeDecodeError(
            "utf-8", b"", 0, 1,
            "invalid UTF-8 in unicode-mode native map (same input fails "
            "the Python map's chunk.decode)")
    raise RuntimeError(f"native map error {rc}")


_UNICODE_TABLES = None


def _unicode_tables():
    """(ws_cps, map_cps, map_offs, map_blob, cased_cps, ignorable_cps) numpy
    arrays generated from Python's own Unicode behavior — str.isspace() and
    str.lower() ARE the semantics the unicode tokenizer mode promises
    (wordcount.tokenize), so deriving the C++ tables from them makes parity
    hold by construction.

    The cased / case-ignorable sets (CPython's Final_Sigma context rule for
    U+03A3) are probed through ``lower()`` itself rather than re-deriving
    Unicode properties: with P1 = "AcΣ".lower() ending in final sigma and
    P2 = "ΑΣc".lower() keeping medial sigma, CPython's own backward/forward
    scans give P1∧P2 ⇔ c case-ignorable and P1∧¬P2 ⇔ c cased."""
    global _UNICODE_TABLES
    if _UNICODE_TABLES is None:
        # probing 0x110000 codepoints through str.lower() costs seconds per
        # process; the result depends only on the interpreter's Unicode
        # tables, so cache it keyed on the unidata version
        import sys
        import unicodedata

        cache = os.path.join(
            BUILD_DIR,
            f"unicode_tables_u{unicodedata.unidata_version}"
            f"_py{sys.version_info[0]}{sys.version_info[1]}.npz")
        try:
            with np.load(cache) as z:
                _UNICODE_TABLES = tuple(
                    z[k] for k in ("ws", "cps", "offs", "blob", "cased",
                                   "ign"))
            return _UNICODE_TABLES
        except (OSError, KeyError, ValueError):
            pass
        ws = np.array([cp for cp in range(0x3001) if chr(cp).isspace()],
                      np.uint32)
        cps, offs, parts = [], [0], []
        cased, ignorable = [], []
        total = 0
        for cp in range(0x110000):
            if 0xD800 <= cp < 0xE000:
                continue  # surrogates: unencodable, never appear decoded
            c = chr(cp)
            low = c.lower()
            if low != c:
                b = low.encode("utf-8")
                cps.append(cp)
                total += len(b)
                offs.append(total)
                parts.append(b)
            p1 = ("A" + c + "Σ").lower()[-1] == "ς"
            p2 = ("ΑΣ" + c).lower()[1] == "ς"
            if p1 and not p2:
                cased.append(cp)
            elif p1 and p2:
                ignorable.append(cp)
        _UNICODE_TABLES = (
            ws,
            np.array(cps, np.uint32),
            np.array(offs, np.int64),
            np.frombuffer(b"".join(parts), np.uint8).copy(),
            np.array(cased, np.uint32),
            np.array(ignorable, np.uint32),
        )
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=BUILD_DIR)
            with os.fdopen(fd, "wb") as f:
                t = _UNICODE_TABLES
                np.savez(f, ws=t[0], cps=t[1], offs=t[2], blob=t[3],
                         cased=t[4], ign=t[5])
            os.replace(tmp, cache)
        except OSError:
            pass  # cache is best-effort; probing again next process is fine
    return _UNICODE_TABLES


class NativeStream:
    """Persistent native mapper state: per-chunk (hash, count) columns plus a
    cross-chunk C++ dictionary drained as deltas.

    Not thread-safe per instance — ``map_chunk`` serializes on a lock (the
    C++ loop is single-core-bound anyway; concurrent callers would only
    interleave on one core)."""

    def __init__(self, ngram: int = 1, tokenizer: str = "ascii"):
        if not 1 <= ngram <= 16:
            raise ValueError("ngram must be in [1, 16]")
        self._lib = _load_lib()
        self._st = self._lib.moxt_new(ngram)
        if not self._st:
            raise RuntimeError("moxt_new failed")
        self.ngram = ngram
        self.tokenizer = tokenizer
        if tokenizer == "unicode":
            ws, cps, offs, blob, cased, ign = _unicode_tables()
            rc = self._lib.moxt_set_unicode(
                self._st, ws.ctypes.data, ws.size, cps.ctypes.data,
                offs.ctypes.data, blob.ctypes.data, cps.size,
                cased.ctypes.data, cased.size, ign.ctypes.data, ign.size)
            if rc:
                raise RuntimeError(f"moxt_set_unicode failed ({rc})")
        elif tokenizer != "ascii":
            raise ValueError(f"unknown tokenizer {tokenizer!r}")
        self._lock = threading.Lock()

    def close(self) -> None:
        if self._st:
            self._lib.moxt_free(self._st)
            self._st = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def map_chunk(self, chunk, drain_dict: bool = True) -> MapOutput:
        """Map one chunk (any buffer-protocol object: bytes, memoryview,
        bytearray — passed to C by pointer, zero-copy)."""
        view = np.frombuffer(chunk, np.uint8)
        with self._lock:
            rc = self._lib.moxt_map(self._st, view.ctypes.data, view.size)
            return self._collect_locked(rc, drain_dict)

    def _collect_locked(self, rc: int, drain_dict: bool) -> MapOutput:
        _raise_map_error(rc)
        nu = int(self._lib.moxt_chunk_unique(self._st))
        n_tokens = int(self._lib.moxt_chunk_tokens(self._st))
        hashes = np.empty(nu, np.uint64)
        counts = np.empty(nu, np.int32)
        if nu:
            self._lib.moxt_chunk_read(
                self._st, hashes.ctypes.data, counts.ctypes.data)
        d = self._drain_dict_locked() if drain_dict else HashDictionary()
        hi, lo = split_u64(hashes)
        records = max(n_tokens - (self.ngram - 1), 0) if n_tokens else 0
        return MapOutput(hi=hi, lo=lo, values=counts, dictionary=d,
                         records_in=records)

    def _iter_file_ranges(self, path: str, start_offset: int, map_range,
                          collect, what: str):
        """mmap range-iteration skeleton: open/size, per-range
        ``map_range(file, off) -> consumed`` under the lock, negative-rc
        error mapping, stall detection, ``collect()`` readback, close.
        Yields ``(collected, next_offset)``."""
        f = self._lib.moxt_file_open(os.fsencode(path))
        if not f:
            raise OSError(f"cannot open/mmap {path!r}")
        try:
            size = int(self._lib.moxt_file_size(f))
            off = start_offset
            while off < size:
                with self._lock:
                    consumed = int(map_range(f, off))
                    if consumed < 0:
                        _raise_map_error(-consumed)
                    if consumed == 0:
                        raise RuntimeError(
                            f"native {what} stalled at {off}")
                    out = collect()
                off += consumed
                yield out, off
        finally:
            self._lib.moxt_file_close(f)

    def iter_file(self, path: str, chunk_bytes: int, start_offset: int = 0):
        """Map a file via the C++ mmap path: zero kernel->user copies, chunk
        cuts chosen in C (last newline, then last whitespace, then hard cut —
        the same bounded-carry policy as io.splitter.iter_chunks).  Yields
        ``(MapOutput, next_offset)`` per chunk; ``start_offset`` resumes at a
        previous run's cut boundary (checkpoint/resume contract: the cut
        policy is deterministic in (offset, chunk_bytes), so the resumed
        chunk stream is identical to a fresh run's tail)."""
        return self._iter_file_ranges(
            path, start_offset,
            lambda f, off: self._lib.moxt_map_range(
                self._st, f, off, chunk_bytes),
            lambda: self._collect_locked(0, drain_dict=True), "map_range")

    def _drain_dict_locked(self) -> HashDictionary:
        n = ctypes.c_int64()
        nbytes = ctypes.c_int64()
        self._lib.moxt_dict_pending(self._st, ctypes.byref(n),
                                    ctypes.byref(nbytes))
        d = HashDictionary()
        if not n.value:
            return d
        hashes = np.empty(n.value, np.uint64)
        lens = np.empty(n.value, np.int32)
        blob = np.empty(max(nbytes.value, 1), np.uint8)
        self._lib.moxt_dict_read(self._st, hashes.ctypes.data,
                                 lens.ctypes.data, blob.ctypes.data)
        # columnar delta, O(1): the per-key materialization loop runs once
        # at the consumer's first lookup, not per chunk
        d.add_arrays(hashes, lens, blob.tobytes())
        return d


class StreamPool:
    """One :class:`NativeStream` per calling thread.

    A single stream serializes on its lock, which would collapse a
    multi-worker map phase onto one core; per-thread streams keep the
    GIL-released C calls truly parallel.  Each stream owns its own C++
    dictionary — the per-chunk deltas from different threads may overlap,
    but ``HashDictionary.update`` is idempotent (and collision-checking), so
    the driver-side union is still exact."""

    def __init__(self, ngram: int = 1, tokenizer: str = "ascii"):
        self.ngram = ngram
        self.tokenizer = tokenizer
        self._tls = threading.local()
        self._streams: list[NativeStream] = []
        self._lock = threading.Lock()

    def get(self) -> NativeStream:
        s = getattr(self._tls, "stream", None)
        if s is None:
            s = NativeStream(self.ngram, self.tokenizer)
            self._tls.stream = s
            with self._lock:
                self._streams.append(s)
        return s

    def map_chunk(self, chunk) -> MapOutput:
        return self.get().map_chunk(chunk)

    def iter_file(self, path: str, chunk_bytes: int, start_offset: int = 0):
        return self.get().iter_file(path, chunk_bytes, start_offset)

    def close(self) -> None:
        with self._lock:
            for s in self._streams:
                s.close()
            self._streams.clear()


class NativeMapper:
    """Stateless facade: a fresh native state per call, full dictionary
    returned with every chunk.  Used by parity tests and ad-hoc callers;
    drivers use :class:`NativeStream`."""

    def __init__(self):
        self._lib = _load_lib()

    def map_wordcount(self, chunk: bytes) -> MapOutput:
        s = NativeStream(1)
        try:
            return s.map_chunk(chunk)
        finally:
            s.close()
