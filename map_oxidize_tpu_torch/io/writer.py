"""Deterministic final-result writer (a copy of the JAX package's, so the
two packages write byte-identical files).

The file is atomically replaced (write temp + rename) and rows are sorted by
word ascending, so identical inputs yield byte-identical outputs.
"""

from __future__ import annotations

import os
from typing import Iterable


def write_final_result(path: str, counts: Iterable[tuple[bytes, int]]) -> int:
    """Write ``"{word} {count}\\n"`` rows (the reference's line format,
    main.rs:178) sorted by word; atomic replace.  Returns row count."""
    rows = sorted(counts, key=lambda kv: kv[0])
    tmp = f"{path}.tmp.{os.getpid()}"
    n = 0
    with open(tmp, "wb") as f:
        for word, count in rows:
            f.write(word + b" " + str(int(count)).encode() + b"\n")
            n += 1
    os.replace(tmp, path)
    return n


def format_top_words(top: list[tuple[bytes, int]], k: int) -> str:
    """The reference's stdout report (main.rs:188-191): ``Top {k} words:``
    then ``{word}: {count}`` lines."""
    lines = [f"Top {k} words:"]
    for word, count in top[:k]:
        lines.append(f"{word.decode('utf-8', 'replace')}: {count}")
    return "\n".join(lines)
