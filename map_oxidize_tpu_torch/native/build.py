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
while a chunk maps.  :func:`library_path` and :func:`_compile` take another
source and name stem too: the device map's dictionary builder
(``runtime/csrc/device_dict.cpp``) is built by them, beside this library.

Two wrapper flavours over the same stateful C API (``moxt_new`` /
``moxt_map`` / ``moxt_chunk_read`` / ``moxt_dict_read``):

* :class:`NativeStream` — one persistent state per workload instance.  The
  hash->bytes dictionary lives in C++ across chunks and each ``map_chunk``
  drains only the *delta* of newly seen keys, so steady-state chunks hand
  back (hash, count) arrays and ~no strings.
* :class:`NativeMapper` — the stateless per-call facade (fresh state each
  call) used by parity tests and one-shot callers.

Bound (the JAX package's ``native/build.py``): the word-count map, the
inverted index's doc-pair map (``map_docs`` :383, ``iter_file_docs`` :397),
the hash-only map and the rescan that resolves its strings
(``map_chunk_hashes`` :409, ``iter_file_hashes`` :432, ``resolve_file``
:473), the HLL fold (``map_chunk_hll`` :443, ``iter_file_hll`` :461), the
dictionary drain (:558), and the host sort helpers of the collect engines
(``sort_kd_or_none`` :564, ``sort_u64_blocks_or_none`` :598,
``count_u64_or_none`` :631, ``group_by_key_or_none`` :664).  The helpers
return None (or False) only for input they cannot take in place or for a
failed scratch allocation, and the caller's numpy path then gives the same
result; a failed build raises, as everywhere in the port.
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


def library_path(src: str = _SRC, stem: str = "libmoxt_native_port") -> str:
    """Where the library built from ``src`` lives: ``<stem>-<digest>.so``
    in :data:`BUILD_DIR`."""
    with open(src, "rb") as f:
        code = f.read()
    digest = hashlib.sha256(
        code + " ".join((CXX, *CXX_FLAGS)).encode() + _target()).hexdigest()
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def _compile(force: bool = False, src: str = _SRC,
             stem: str = "libmoxt_native_port") -> str:
    """Build the library of ``src`` unless a current one exists (always,
    with ``force``); raises with the compiler's output when the build
    fails."""
    so = library_path(src, stem)
    if os.path.isfile(so) and not force:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temp name + atomic rename so concurrent builders are safe
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([CXX, *CXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e.stderr}") from e
    except OSError as e:  # no compiler at that path
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e}") from e
    os.replace(tmp, so)
    _log.info("built native library: %s", so)
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
                ("moxt_map_range", i64, [p, p, i64, i64]),
                ("moxt_map_docs", i32, [p, p, i64, i64]),
                ("moxt_pairs_n", i64, [p]),
                ("moxt_pairs_read", None, [p, p, p]),
                ("moxt_map_range_docs", i64, [p, p, i64, i64]),
                ("moxt_map_hashes", i32, [p, p, i64]),
                ("moxt_hashes_n", i64, [p]),
                ("moxt_hashes_read", None, [p, p]),
                ("moxt_map_range_hashes", i64, [p, p, i64, i64]),
                ("moxt_map_hll", i32, [p, p, i64, i32]),
                ("moxt_hll_read", None, [p, p]),
                ("moxt_map_range_hll", i64, [p, p, i64, i64, i32]),
                ("moxt_resolve_begin", i32, [p, p, i64]),
                ("moxt_resolve_range", i64, [p, p, i64, i64]),
                ("moxt_resolve_found", i64, [p, p]),
                ("moxt_resolve_remaining", i64, [p]),
                ("moxt_resolve_read", None, [p, p, p, p]),
                ("moxt_sort_kd", i32, [p, p, i64]),
                ("moxt_sort_u64_blocks", i32, [p, p, i32, p, p, i64]),
                ("moxt_count_u64", i64, [p, i64, p, p]),
                ("moxt_group_by_key", i32, [p, p, i64, p, i64, p, p])):
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

    def _collect_pairs_locked(self) -> MapOutput:
        n = int(self._lib.moxt_pairs_n(self._st))
        n_tokens = int(self._lib.moxt_chunk_tokens(self._st))
        hashes = np.empty(n, np.uint64)
        docs = np.empty(n, np.int64)
        if n:
            self._lib.moxt_pairs_read(self._st, hashes.ctypes.data,
                                      docs.ctypes.data)
        d = self._drain_dict_locked()
        # compact form: the host collect engine consumes (keys64, docs64)
        # directly; plane-bound consumers (checkpoint spill, device sort)
        # materialize hi/lo + (n, 2) doc planes via ensure_planes()
        return MapOutput(hi=None, lo=None, values=None, dictionary=d,
                         records_in=n_tokens, keys64=hashes, docs64=docs)

    def map_docs(self, chunk, base_doc: int = 0) -> MapOutput:
        """Inverted-index map of one chunk: one row per distinct term per
        document (doc id = ``base_doc`` + in-chunk line offset)."""
        view = np.frombuffer(chunk, np.uint8)
        with self._lock:
            rc = self._lib.moxt_map_docs(self._st, view.ctypes.data,
                                         view.size, base_doc)
            if rc == 1:
                raise ValueError("64-bit hash collision in native map")
            if rc:
                raise RuntimeError(f"native map_docs error {rc}")
            return self._collect_pairs_locked()

    def iter_file_docs(self, path: str, chunk_bytes: int,
                       start_offset: int = 0):
        """mmap inverted-index map over a file; doc ids are absolute byte
        offsets of line starts.  Yields ``(MapOutput, next_offset)`` per
        chunk; the doc-mode cut policy (newline only) is deterministic in
        (offset, chunk_bytes), so a resume at a previous boundary maps the
        same chunks as a fresh run's tail."""
        return self._iter_file_ranges(
            path, start_offset,
            lambda f, off: self._lib.moxt_map_range_docs(
                self._st, f, off, chunk_bytes),
            self._collect_pairs_locked, "map_range_docs")

    def map_chunk_hashes(self, chunk) -> MapOutput:
        """Hash-only map of one chunk: one raw n-gram hash per window, no
        tables, no strings (the collect reduce's compact form; the counts
        are implicit ones)."""
        view = np.frombuffer(chunk, np.uint8)
        with self._lock:
            rc = self._lib.moxt_map_hashes(self._st, view.ctypes.data,
                                           view.size)
            return self._collect_hashes_locked(rc)

    def _collect_hashes_locked(self, rc: int) -> MapOutput:
        _raise_map_error(rc)
        n = int(self._lib.moxt_hashes_n(self._st))
        hashes = np.empty(n, np.uint64)
        if n:
            self._lib.moxt_hashes_read(self._st, hashes.ctypes.data)
        return MapOutput(hi=None, lo=None, values=None,
                         dictionary=HashDictionary(), records_in=n,
                         keys64=hashes)

    def iter_file_hashes(self, path: str, chunk_bytes: int,
                         start_offset: int = 0):
        """mmap hash-only map over a file; the same cut policy (and so the
        same resume offsets) as :meth:`iter_file`.  Yields
        ``(MapOutput, next_offset)``."""
        return self._iter_file_ranges(
            path, start_offset,
            lambda f, off: self._lib.moxt_map_range_hashes(
                self._st, f, off, chunk_bytes),
            lambda: self._collect_hashes_locked(0), "map_range_hashes")

    def map_chunk_hll(self, chunk, p: int):
        """HLL-fold map of one chunk: the scan max-folds (top-p-bits
        bucket, leading-zero rank) into ``2^p`` uint8 registers in C.
        Returns ``(registers, n_tokens)``, the register semantics of
        ``workloads.distinct.hll_registers``."""
        view = np.frombuffer(chunk, np.uint8)
        with self._lock:
            rc = self._lib.moxt_map_hll(self._st, view.ctypes.data,
                                        view.size, p)
            return self._collect_hll_locked(rc, p)

    def _collect_hll_locked(self, rc: int, p: int):
        _raise_map_error(rc)
        regs = np.empty(1 << p, np.uint8)
        self._lib.moxt_hll_read(self._st, regs.ctypes.data)
        return regs, int(self._lib.moxt_chunk_tokens(self._st))

    def iter_file_hll(self, path: str, chunk_bytes: int, p: int,
                      start_offset: int = 0):
        """mmap HLL-fold map over a file; the cut policy of
        :meth:`iter_file_hashes`.  Yields ``(registers, n_tokens,
        next_offset)``."""
        for (regs, n_tokens), off in self._iter_file_ranges(
                path, start_offset,
                lambda f, off: self._lib.moxt_map_range_hll(
                    self._st, f, off, chunk_bytes, p),
                lambda: self._collect_hll_locked(0, p), "map_range_hll"):
            yield regs, n_tokens, off

    def resolve_file(self, path: str, chunk_bytes: int, hashes: np.ndarray,
                     early_stop: bool = True):
        """Recover key bytes for ``hashes`` by rescanning the corpus with
        the SAME chunk cuts the hash-only map used.  Returns
        ``(found_hashes u64, lens i32, blob bytes)``; a 64-bit collision
        involving any queried key raises (the first occurrence's bytes are
        compared against every later occurrence in the scanned range).

        ``early_stop`` ends the scan as soon as every queried hash has been
        seen once; the collision byte-check then covers the scanned prefix
        only.  ``early_stop=False`` (config ``rescan_full``) scans the
        whole corpus."""
        hashes = np.ascontiguousarray(hashes, np.uint64)
        with self._lock:
            rc = self._lib.moxt_resolve_begin(
                self._st, hashes.ctypes.data, hashes.size)
            if rc:
                raise RuntimeError(f"moxt_resolve_begin failed ({rc})")
            if hashes.size == 0:
                return (np.empty(0, np.uint64), np.empty(0, np.int32), b"")
            f = self._lib.moxt_file_open(os.fsencode(path))
            if not f:
                raise OSError(f"cannot open/mmap {path!r}")
            try:
                size = int(self._lib.moxt_file_size(f))
                off = 0
                while off < size:
                    consumed = int(self._lib.moxt_resolve_range(
                        self._st, f, off, chunk_bytes))
                    if consumed < 0:
                        _raise_map_error(-consumed)
                    if consumed == 0:
                        raise RuntimeError(
                            f"native resolve_range stalled at {off}")
                    off += consumed
                    if (early_stop
                            and self._lib.moxt_resolve_remaining(self._st)
                            == 0):
                        if off < size:
                            _log.info(
                                "resolve early-stop at %d/%d bytes "
                                "(%.1f%%); collision byte-check covers the "
                                "scanned prefix only", off, size,
                                100.0 * off / size)
                        break
            finally:
                self._lib.moxt_file_close(f)
            nbytes = ctypes.c_int64()
            n = int(self._lib.moxt_resolve_found(self._st,
                                                 ctypes.byref(nbytes)))
            out_h = np.empty(n, np.uint64)
            out_len = np.empty(n, np.int32)
            blob = np.empty(max(int(nbytes.value), 1), np.uint8)
            if n:
                self._lib.moxt_resolve_read(
                    self._st, out_h.ctypes.data, out_len.ctypes.data,
                    blob.ctypes.data)
            return out_h, out_len, blob.tobytes()[:int(nbytes.value)]

    def drain_dictionary(self) -> HashDictionary:
        """Novel (hash -> bytes) entries since the last drain."""
        with self._lock:
            return self._drain_dict_locked()

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


def _contiguous(a, dtype, writeable: bool = False) -> bool:
    return (a.dtype == np.dtype(dtype) and a.ndim == 1
            and a.flags.c_contiguous and (a.flags.writeable or not writeable))


def sort_kd_or_none(keys: np.ndarray, docs: np.ndarray | None) -> bool:
    """In-place stable ascending radix sort of ``keys`` (uint64) with
    ``docs`` (int64) riding along; GIL released.  Returns True on success,
    False for input it cannot sort in place (a copy would sort the copy, a
    wrong dtype would sort bitwise-wrong, a read-only buffer would be
    mutated behind numpy's back) or a failed scratch allocation — the
    caller's numpy sort then runs."""
    lib = _load_lib()
    if not _contiguous(keys, np.uint64, True) or (docs is not None and not (
            _contiguous(docs, np.int64, True)
            and docs.shape == keys.shape)):
        return False
    rc = lib.moxt_sort_kd(
        keys.ctypes.data,
        docs.ctypes.data if docs is not None else None,
        keys.shape[0])
    if rc:
        _log.warning("native radix sort could not allocate scratch; "
                     "sorting with numpy")
        return False
    return True


def sort_u64_blocks_or_none(blocks: list) -> "np.ndarray | None":
    """Sort the concatenation of ``blocks`` (each a contiguous u64 array)
    ascending without materializing the concatenation first: the radix
    reads the blocks in place for its histogram and first scatter.
    Returns a new sorted array, or None when a block is unsuitable or
    scratch allocation fails."""
    lib = _load_lib()
    if not all(_contiguous(b, np.uint64) for b in blocks):
        return None
    n = int(sum(b.shape[0] for b in blocks))
    if n == 0:
        return np.empty(0, np.uint64)
    live = [b for b in blocks if b.shape[0]]
    ptrs = (ctypes.c_void_p * len(live))(*[b.ctypes.data for b in live])
    lens = (ctypes.c_int64 * len(live))(*[b.shape[0] for b in live])
    out = np.empty(n, np.uint64)
    tmp = np.empty(n, np.uint64)
    rc = lib.moxt_sort_u64_blocks(ptrs, lens, len(live), out.ctypes.data,
                                  tmp.ctypes.data, n)
    if rc:
        _log.warning("native blocks radix sort could not allocate "
                     "scratch; sorting otherwise")
        return None
    return out


def count_u64_or_none(keys: np.ndarray):
    """Fused unique+count of u64 hash keys: MSD partition + per-bucket
    in-cache LSD + run emission in one call.  ``keys`` is read-only.
    Returns ``(uniques ascending, counts int32)``, or None when the input
    is unsuitable or scratch allocation fails.  n >= 2^31 is refused: one
    key with that many occurrences would truncate its int32 count."""
    lib = _load_lib()
    if not _contiguous(keys, np.uint64):
        return None
    n = int(keys.shape[0])
    if n >= 1 << 31:
        return None
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int32)
    out_k = np.empty(n, np.uint64)
    out_c = np.empty(n, np.int32)
    m = int(lib.moxt_count_u64(keys.ctypes.data, n, out_k.ctypes.data,
                               out_c.ctypes.data))
    if m < 0:
        _log.warning("native count_u64 could not allocate scratch; "
                     "sorting instead")
        return None
    return out_k[:m].copy(), out_c[:m].copy()


def group_by_key_or_none(keys: np.ndarray, docs: np.ndarray,
                         uniq: np.ndarray):
    """Group ``docs`` by ``keys`` against the known distinct-key set
    ``uniq`` (ascending u64) without a sort: a hash->dense-id table, a
    counting pass, a scatter pass (feed order per term preserved, the sort
    path's stability contract).  Returns ``(offsets i64[m+1], docs_grouped
    i64[n])``, or None when dtypes are unsuitable, scratch allocation
    fails, or the contract is violated (a duplicate uniq entry, a key
    missing from uniq) — callers then take the sort path."""
    lib = _load_lib()
    if not (_contiguous(keys, np.uint64) and _contiguous(docs, np.int64)
            and _contiguous(uniq, np.uint64) and docs.shape == keys.shape):
        return None
    n = int(keys.shape[0])
    m = int(uniq.shape[0])
    if m == 0:
        return None
    out_off = np.empty(m + 1, np.int64)
    out_docs = np.empty(max(n, 1), np.int64)
    rc = int(lib.moxt_group_by_key(
        keys.ctypes.data, docs.ctypes.data, n, uniq.ctypes.data, m,
        out_off.ctypes.data, out_docs.ctypes.data))
    if rc == -1:
        _log.warning("native group_by_key could not allocate scratch; "
                     "sorting instead")
        return None
    if rc:
        _log.warning("group_by_key contract violation (dictionary does not "
                     "exactly cover the fed keys); sorting instead")
        return None
    return out_off, out_docs[:n]


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

    def map_docs(self, chunk, base_doc: int = 0) -> MapOutput:
        return self.get().map_docs(chunk, base_doc)

    def iter_file_docs(self, path: str, chunk_bytes: int,
                       start_offset: int = 0):
        return self.get().iter_file_docs(path, chunk_bytes, start_offset)

    def iter_file_hashes(self, path: str, chunk_bytes: int,
                         start_offset: int = 0):
        return self.get().iter_file_hashes(path, chunk_bytes, start_offset)

    def map_chunk_hashes(self, chunk) -> MapOutput:
        return self.get().map_chunk_hashes(chunk)

    def map_chunk_hll(self, chunk, p: int):
        return self.get().map_chunk_hll(chunk, p)

    def iter_file_hll(self, path: str, chunk_bytes: int, p: int,
                      start_offset: int = 0):
        return self.get().iter_file_hll(path, chunk_bytes, p, start_offset)

    def resolve_file(self, path: str, chunk_bytes: int, hashes,
                     early_stop: bool = True):
        return self.get().resolve_file(path, chunk_bytes, hashes, early_stop)

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

    def map_ngram(self, chunk: bytes, n: int) -> MapOutput:
        s = NativeStream(n)
        try:
            return s.map_chunk(chunk)
        finally:
            s.close()

    def map_wordcount(self, chunk: bytes) -> MapOutput:
        return self.map_ngram(chunk, 1)

    def map_bigram(self, chunk: bytes) -> MapOutput:
        return self.map_ngram(chunk, 2)


def load_native() -> NativeMapper:
    """The stateless facade, building the library first if needed (a
    failed build raises)."""
    return NativeMapper()
