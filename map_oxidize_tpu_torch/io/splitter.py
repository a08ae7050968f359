"""Input splitting (a copy of the JAX package's streaming splitters, so the
port imports nothing from it).

Chunks are contiguous byte ranges cut at whitespace and yielded lazily, so a
large corpus never sits in host memory and no token straddles two chunks.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Iterator, NamedTuple


def iter_chunks(path: str, chunk_bytes: int,
                start_offset: int = 0) -> Iterator[bytes]:
    """Yield newline-aligned chunks of AT MOST ``chunk_bytes`` each.

    ``start_offset`` resumes mid-file: it must be a previous run's chunk
    boundary (a cut point), in which case the yielded chunks are identical to
    the tail of a fresh run's — the checkpoint/resume contract.

    Yields ``memoryview``s over per-chunk buffers filled with ``readinto`` —
    one kernel->user copy per byte, no re-slicing copies (the map hot loop
    takes any buffer-protocol object).  The carry (the partial trailing line)
    is the only re-copied region.

    Cut policy — the same as the JAX package's splitter and its native mmap
    path, so chunking-dependent workloads count the same on every path: a
    fixed window of ``chunk_bytes`` is cut at its last newline,
    falling back to the last ASCII whitespace (token semantics only need
    whitespace boundaries), then to a hard split for a window-sized token —
    host residency stays O(chunk_bytes) no matter the input (the reference
    buffers whole lines, main.rs:44-48).
    """
    with open(path, "rb", buffering=0) as f:
        size = os.fstat(f.fileno()).st_size
        off = start_offset   # absolute offset of the next unconsumed byte
        if start_offset:
            f.seek(start_offset)
        carry = b""
        while off < size:
            want = min(chunk_bytes, size - off)
            buf = bytearray(want)
            pos = len(carry)
            buf[:pos] = carry
            while pos < want:  # raw files may short-read; fill the window
                n = f.readinto(memoryview(buf)[pos:])
                if not n:
                    break
                pos += n
            if pos == 0:
                return
            mv = memoryview(buf)[:pos]
            if off + pos >= size or pos < want:
                yield mv           # final window: uncut, like the C path
                return
            cut = buf.rfind(b"\n", 0, pos)
            if cut == -1:
                cut = _last_ws(mv)  # newline-free: any whitespace
            consumed = (cut + 1) if cut != -1 else pos  # giant token: hard
            yield mv[:consumed]
            carry = bytes(mv[consumed:pos])
            off += consumed


_ASCII_WS = b" \t\n\r\x0b\x0c"


def _last_ws(block) -> int:
    """Index of the last ASCII-whitespace byte in ``block`` or -1."""
    block = bytes(block) if not isinstance(block, (bytes, bytearray)) else block
    best = -1
    for w in _ASCII_WS:
        i = block.rfind(w)
        if i > best:
            best = i
    return best


def iter_chunks_capped(path: str, chunk_bytes: int, start_offset: int = 0):
    """Yield chunks of AT MOST ``chunk_bytes``, split at whitespace.

    For consumers with a fixed-size device buffer (the on-device tokenizer):
    token semantics only require that no token straddles a chunk, and any
    ASCII whitespace is a safe cut point — newline alignment is not needed.
    A single token longer than ``chunk_bytes`` is hard-split (and counted as
    two tokens); at real chunk sizes that means a >32MB whitespace-free run.

    ``start_offset`` resumes at a previous run's cut boundary; the cut policy
    is deterministic in (offset, chunk_bytes), so the resumed chunk stream
    equals a fresh run's tail (the snapshot/resume contract).  Chunks are
    contiguous, so a consumer's next resume offset is its running sum of
    yielded lengths.
    """
    with open(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        carry = b""
        while True:
            block = carry + f.read(chunk_bytes - len(carry))
            if not block:
                return
            if len(block) < chunk_bytes:
                yield block
                return
            cut = _last_ws(block)
            if cut == -1:
                yield block          # pathological giant token: hard split
                carry = b""
            else:
                yield block[: cut + 1]
                carry = block[cut + 1:]


#: bytes at a window's end that :func:`iter_chunks_into` scans for its cut
#: first: the window's last whitespace lies there whenever they hold any
_CUT_TAIL = 1 << 12


class FilledChunk(NamedTuple):
    """One chunk of :func:`iter_chunks_into`, in its caller's buffer."""

    #: the caller's buffer; its first ``length`` bytes are the chunk
    buf: Any
    length: int
    #: bytes moved from the previous window's tail to the buffer's head
    carry_in: int
    #: the cut needed more than the tail scan (a hard split included)
    cut_fallback: bool

    @property
    def data(self) -> memoryview:
        """The chunk's bytes: a view into ``buf``."""
        return memoryview(self.buf).cast("B")[:self.length]


def iter_chunks_into(path: str, chunk_bytes: int, buffer_for,
                     start_offset: int = 0) -> Iterator[FilledChunk]:
    """:func:`iter_chunks_capped`'s chunks, each read straight into a
    buffer of the caller's, with no other copy of its bytes.

    ``buffer_for(seq)`` returns a writable, contiguous uint8 array of at
    least ``chunk_bytes`` for chunk ``seq`` (a pinned staging slot); it is
    asked for before the chunk is read.  The previous window's carry (the
    bytes after its cut, usually less than a token) goes to the buffer's
    head and ``readinto`` fills the rest of the window from the file.  The
    cut is found in the buffer: in the window's last :data:`_CUT_TAIL`
    bytes, else in the whole window, else a hard split; the same cut as
    :func:`_last_ws` of the window, so the chunks and their offsets are
    :func:`iter_chunks_capped`'s for any ``start_offset`` (the
    snapshot/resume contract).

    The carry is copied out before the chunk is yielded, so the buffer's
    bytes past ``length`` are the caller's to overwrite (with padding).
    """
    with open(path, "rb", buffering=0) as f:
        if start_offset:
            f.seek(start_offset)
        carry = b""
        for seq in itertools.count():
            buf = buffer_for(seq)
            mv = memoryview(buf).cast("B")[:chunk_bytes]
            if mv.nbytes < chunk_bytes:
                raise ValueError(f"buffer of {mv.nbytes} bytes for "
                                 f"{chunk_bytes}-byte chunks")
            pos = len(carry)
            mv[:pos] = carry
            while pos < chunk_bytes:  # raw files may short-read
                n = f.readinto(mv[pos:])
                if not n:
                    break
                pos += n
            if pos == 0:
                return
            if pos < chunk_bytes:  # the final window: uncut
                yield FilledChunk(buf, pos, len(carry), False)
                return
            cut, fallback = _last_ws_tail(mv)
            consumed = cut + 1 if cut != -1 else pos  # giant token: hard
            chunk = FilledChunk(buf, consumed, len(carry), fallback)
            carry = bytes(mv[consumed:])
            yield chunk


def _last_ws_tail(window) -> tuple[int, bool]:
    """``(_last_ws(window), fallback)``: the tail scan's answer, or the
    whole window's with ``fallback`` set."""
    lo = max(0, len(window) - _CUT_TAIL)
    cut = _last_ws(window[lo:])
    if cut != -1:
        return lo + cut, False
    return (_last_ws(window[:lo]) if lo else -1), True


def iter_doc_chunks(path: str, chunk_bytes: int,
                    start_offset: int = 0) -> Iterator[bytes]:
    """Newline-ONLY chunking for document-keyed workloads (inverted index;
    JAX ``io/splitter.py:124``):
    every chunk starts at a line start, so in-chunk byte offsets are valid
    doc ids.  A window with no newline EXTENDS to the next one instead of
    cutting at whitespace — mirroring the native ``moxt_map_range_docs``
    policy exactly.  Residency is O(longest document).

    ``start_offset`` resumes at a previous run's chunk boundary (always a
    line start); the cut policy is deterministic, so the resumed stream is
    identical to a fresh run's tail — the checkpoint/resume contract."""
    with open(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        data_pos = start_offset
        size = os.fstat(f.fileno()).st_size
        carry = b""
        while data_pos < size or carry:
            block = f.read(max(chunk_bytes - len(carry), 1))
            data_pos = f.tell()
            buf = carry + block
            if data_pos >= size:          # EOF: remainder is the last chunk
                if buf:
                    yield buf
                return
            cut = buf.rfind(b"\n")
            while cut == -1:              # extend to the next newline
                more = f.read(chunk_bytes)
                data_pos = f.tell()
                if not more:
                    yield buf
                    return
                ext = more.find(b"\n")
                if ext == -1:
                    buf += more
                    continue
                buf += more[:ext + 1]
                carry = more[ext + 1:]
                yield buf
                break
            else:
                yield buf[: cut + 1]
                carry = buf[cut + 1:]


def plan_chunks(path: str, chunk_bytes: int, num_chunks: int = 0) -> tuple[int, int]:
    """Return (num_chunks_estimate, chunk_bytes).  If ``num_chunks`` is given,
    derive chunk_bytes from the file size instead (reference semantics:
    a fixed chunk count, main.rs:13)."""
    size = os.path.getsize(path)
    if num_chunks > 0:
        cb = max(1, -(-size // num_chunks))  # ceil div
        return num_chunks, cb
    return max(1, -(-size // chunk_bytes)), chunk_bytes


def split_round_robin(path: str, num_chunks: int) -> list[bytes]:
    """Reference-exact chunking: line ``i`` goes to chunk ``i % num_chunks``
    with '\\n' re-appended (the reference's src/main.rs:44-48).  Whole file
    resident — only for the ``--num-chunks`` compat mode and tiny inputs."""
    chunks = [bytearray() for _ in range(num_chunks)]
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()  # trailing newline does not produce an empty final line
    i = 0
    for line in lines:
        chunks[i] += line + b"\n"
        i = (i + 1) % num_chunks
    return [bytes(c) for c in chunks]
