"""Input splitting (a copy of the JAX package's streaming splitters, so the
port imports nothing from it).

Chunks are contiguous byte ranges cut at whitespace and yielded lazily, so a
large corpus never sits in host memory and no token straddles two chunks.
"""

from __future__ import annotations

import os
from typing import Iterator


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


def plan_chunks(path: str, chunk_bytes: int, num_chunks: int = 0) -> tuple[int, int]:
    """Return (num_chunks_estimate, chunk_bytes).  If ``num_chunks`` is given,
    derive chunk_bytes from the file size instead (reference semantics:
    a fixed chunk count, main.rs:13)."""
    size = os.path.getsize(path)
    if num_chunks > 0:
        cb = max(1, -(-size // num_chunks))  # ceil div
        return num_chunks, cb
    return max(1, -(-size // chunk_bytes)), chunk_bytes
