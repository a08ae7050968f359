"""Pure-host model of the word-count semantics: the golden oracle for
parity tests.  A copy of the JAX package's ``workloads/reference_model.py``
(``wordcount_model`` :23, ``top_k_model`` :31) over the port's own
:func:`~map_oxidize_tpu_torch.workloads.wordcount.tokenize`.

Parity is defined on the multiset of (word, count) pairs and the
count-ordered top-k with a word-ascending tie-break.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

from map_oxidize_tpu_torch.workloads.wordcount import tokenize


def wordcount_model(chunks: Iterable[bytes], mode: str = "ascii") -> Counter:
    """Map every chunk, merge with ``+=``: the semantics end to end."""
    total: Counter = Counter()
    for chunk in chunks:
        total.update(tokenize(chunk, mode))
    return total


def top_k_model(counts: Counter, k: int) -> list[tuple[bytes, int]]:
    """Count-descending top-k with a deterministic (word-ascending)
    tie-break.

    It duplicates the job's top-k expression instead of importing it: the
    oracle stays independent of the code under test.
    """
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
