"""Deterministic result writers (a copy of the JAX package's
``io/writer.py``: ``write_final_result``, ``write_postings`` :31,
``write_postings_stream`` :46, ``format_top_words``), so the two packages
write byte-identical files; ``write_final_result`` also takes rows that
write themselves in native code, to the same bytes.

The file is atomically replaced (write temp + rename) and rows are sorted by
word ascending, so identical inputs yield byte-identical outputs.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable


def write_final_result(path: str, counts: Iterable[tuple[bytes, int]]) -> int:
    """Write ``"{word} {count}\\n"`` rows (the reference's line format,
    main.rs:178) sorted by word; atomic replace.  Returns row count.

    Rows that can write themselves (a ``write_native(fd)`` that is not
    None: the device map's counts over its native dictionary) are looked
    up, sorted, formatted and written by that one call, to the same
    bytes; any other iterable is sorted and written here."""
    write_native = getattr(counts, "write_native", None)
    if write_native is None:
        rows = sorted(counts, key=lambda kv: kv[0])
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            if write_native is not None:
                n = write_native(f.fileno())
            else:
                n = 0
                for word, count in rows:
                    f.write(word + b" " + str(int(count)).encode() + b"\n")
                    n += 1
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    os.replace(tmp, path)
    return n


def write_postings(path: str, postings: dict[bytes, list[int]]) -> int:
    """Inverted-index output: one ``term\\td1 d2 d3...\\n`` line per term,
    terms byte-ascending, doc ids ascending — deterministic and atomic like
    write_final_result.  Returns term count."""
    tmp = f"{path}.tmp.{os.getpid()}"
    n = 0
    with open(tmp, "wb") as f:
        for term in sorted(postings):
            docs = b" ".join(str(d).encode() for d in postings[term])
            f.write(term + b"\t" + docs + b"\n")
            n += 1
    os.replace(tmp, path)
    return n


def write_postings_stream(path: str,
                          items: "Iterable[tuple[bytes, 'object']]"
                          ) -> tuple[int, int]:
    """Streaming variant of :func:`write_postings` for CSR-backed sources:
    ``items`` yields ``(term_bytes, doc_id_array)`` pairs **already in the
    intended term order** with doc ids ascending, and each line streams to
    disk as it is produced — residency is one term's postings, never the
    whole partition (the dict-of-int-lists form boxes every doc id of
    every term at once, which at multi-process scale is exactly the
    blowup the CSR design exists to avoid).  Same line format and atomic
    replace as :func:`write_postings`.  Returns ``(terms, bytes)``
    written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    n = 0
    total = 0
    with open(tmp, "wb") as f:
        for term, docs in items:
            line = (term + b"\t"
                    + b" ".join(b"%d" % d for d in docs.tolist()) + b"\n")
            f.write(line)
            n += 1
            total += len(line)
    os.replace(tmp, path)
    return n, total


def format_top_words(top: list[tuple[bytes, int]], k: int) -> str:
    """The reference's stdout report (main.rs:188-191): ``Top {k} words:``
    then ``{word}: {count}`` lines."""
    lines = [f"Top {k} words:"]
    for word, count in top[:k]:
        lines.append(f"{word.decode('utf-8', 'replace')}: {count}")
    return "\n".join(lines)
