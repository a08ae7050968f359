"""Bytes of ``tokenize_compact`` calls (tokenize, hash and compact one
chunk) from what the inputs need.

Each chunk's bytes are read once, and each token's row, two 32-bit hashes
and a 32-bit start offset, is written once.  The padding rows that the
kernel also writes past the last token are not counted: these inputs do
not need them.  The work is a few integer operations per byte, so bytes
bound it."""

from __future__ import annotations

ROW_BYTES = 12


def count(input_bytes: int, tokens: int) -> tuple[int, int]:
    return 0, input_bytes + ROW_BYTES * tokens
