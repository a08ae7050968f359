"""Text for a word-count job, laid out as Hadoop's RandomTextWriter writes it.

Reads the configuration's ``dataset`` section:

- ``total_bytes``: the file holds whole lines up to this many bytes (it
  stops at the last line that fits, so it is short of it by less than a
  line);
- ``vocab_size``, ``vocab_seed``, ``word_len_min``, ``word_len_max``,
  ``capitalised_share``: the word list, made once from ``vocab_seed`` and
  the same in every run: lower-case ASCII words of a uniform length in
  ``[word_len_min, word_len_max]``, a share of them capitalised, all
  distinct after lower-casing;
- ``key_words_min`` / ``key_words_max``, ``value_words_min`` /
  ``value_words_max``: a line is a key of ``[key_words_min,
  key_words_max)`` words, a tab, a value of ``[value_words_min,
  value_words_max)`` words and a newline; words within the key or the
  value are separated by one space (RandomTextWriter draws the counts with
  ``nextInt(max - min)``, which excludes the maximum);
- ``lines_per_batch``: lines made per device call.

Every word is drawn uniformly from the list.  The draws run on ``device``
from one ``torch.Generator`` seeded with the run's seed, so a seed gives
the same bytes on the same kind of device.  The file is synced to disk
before the run goes on.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def vocabulary(spec: dict) -> list[bytes]:
    """The word list: the same for every run seed."""
    rng = np.random.default_rng(int(spec["vocab_seed"]))
    size = int(spec["vocab_size"])
    lo, hi = int(spec["word_len_min"]), int(spec["word_len_max"])
    words: list[bytes] = []
    seen: set[bytes] = set()
    while len(words) < size:
        w = _LETTERS[rng.integers(0, 26, int(rng.integers(lo, hi + 1)))]
        word = w.tobytes()
        if word in seen:
            continue
        seen.add(word)
        if rng.random() < float(spec["capitalised_share"]):
            word = word[:1].upper() + word[1:]
        words.append(word)
    return words


def generate(spec: dict, seed: int, out_dir: Path, device: str) -> dict:
    words = vocabulary(spec)
    width = max(len(w) for w in words) + 1
    table = np.zeros((len(words), width), np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w, np.uint8)
    table_d = torch.from_numpy(table).to(device)
    lens_d = torch.tensor([len(w) for w in words], dtype=torch.int64,
                          device=device)
    cols = torch.arange(width, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    budget = int(spec["total_bytes"])
    batch = int(spec["lines_per_batch"])
    path = Path(out_dir) / "corpus.txt"
    written = lines = 0
    with open(path, "wb") as f:
        while True:
            kn = torch.randint(int(spec["key_words_min"]),
                               int(spec["key_words_max"]), (batch,),
                               generator=g, device=device)
            vn = torch.randint(int(spec["value_words_min"]),
                               int(spec["value_words_max"]), (batch,),
                               generator=g, device=device)
            per_line = kn + vn
            ids = torch.randint(0, len(words), (int(per_line.sum()),),
                                generator=g, device=device)
            line = torch.repeat_interleave(
                torch.arange(batch, device=device), per_line)
            pos = (torch.arange(ids.shape[0], device=device)
                   - (torch.cumsum(per_line, 0) - per_line)[line])
            sep = torch.full_like(ids, ord(" "))
            sep[pos == kn[line] - 1] = ord("\t")
            sep[pos == per_line[line] - 1] = ord("\n")
            lens = lens_d[ids]
            mat = table_d[ids]
            mat[torch.arange(ids.shape[0], device=device), lens] = sep.to(
                torch.uint8)
            out = mat[cols[None, :] <= lens[:, None]]
            # whole lines only, up to the budget
            line_end = torch.cumsum(
                torch.zeros(batch, dtype=torch.int64, device=device)
                .index_add_(0, line, lens + 1), 0)
            fit = int(torch.searchsorted(line_end, budget - written,
                                         right=True))
            keep = int(line_end[fit - 1]) if fit else 0
            f.write(out[:keep].cpu().numpy())
            written += keep
            lines += fit
            if fit < batch:
                break
        f.flush()
        os.fsync(f.fileno())  # the write-back in set-up, not in the window
    return {"path": str(path), "bytes": written, "lines": lines,
            "vocab_size": len(words)}
