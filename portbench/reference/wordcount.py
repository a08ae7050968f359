"""Plain reference for a word-count job, and the comparison that judges one.

A word is a maximal run of bytes other than ASCII whitespace (space, tab,
newline, carriage return, vertical tab, form feed), with A-Z lowered.  The
reference reads the corpus file the job was given in blocks, cut after
the last whitespace byte of each block so that no word is split, and
counts every word exactly on ``device`` with plain torch operations: the
words' bytes are packed into int64 columns, grouped by a hash of the
columns, and every group is checked byte for byte (a group that is not one
word sends the block to an exact row-wise ``torch.unique``).  It reads
nothing that the program made.

The control breaks the guarantee of exact counts in the way a chunked
reader that ignores word boundaries would: it cuts the corpus at fixed
offsets of the job's ``chunk_bytes``, so every word across a cut is
counted as two pieces.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

BLOCK_BYTES = 1 << 28
_WS = (32, 9, 10, 11, 12, 13)
_MIX = (0x9E3779B97F4A7C15 - (1 << 64), 0x2545F4914F6CDD1D,
        0x5851F42D4C957F2D, 0x14057B7EF767814F)


def _words(block: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keys, lengths)`` of the block's words: ``keys`` is ``(T, 1 +
    ceil(L/8))`` int64, the length and then the lowered bytes, 8 to a
    column, zero past the word's end."""
    ws = torch.zeros_like(block, dtype=torch.bool)
    for w in _WS:
        ws |= block == w
    low = torch.where((block >= 65) & (block <= 90), block + 32, block)
    word = ~ws
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=block.device),
                      word[:-1]])
    nxt = torch.cat([word[1:],
                     torch.zeros(1, dtype=torch.bool, device=block.device)])
    starts = torch.nonzero(word & ~prev).squeeze(1)
    ends = torch.nonzero(word & ~nxt).squeeze(1)
    lengths = ends - starts + 1
    cols = [lengths]
    longest = int(lengths.max()) if lengths.numel() else 0
    last = block.shape[0] - 1
    for j0 in range(0, longest, 8):
        acc = torch.zeros_like(starts)
        for j in range(j0, min(j0 + 8, longest)):
            b = low[(starts + j).clamp(max=last)].to(torch.int64)
            acc |= (b * (lengths > j)) << (8 * (j - j0))
        cols.append(acc)
    return torch.stack(cols, 1), lengths


def _decode(row: list[int]) -> bytes:
    length = row[0]
    raw = b"".join(int(v).to_bytes(8, "little", signed=True)
                   for v in row[1:])
    return raw[:length]


def _count_block(block: torch.Tensor, out: dict) -> None:
    keys, _ = _words(block)
    if keys.shape[0] == 0:
        return
    h = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for j in range(keys.shape[1]):
        h = h * _MIX[j % len(_MIX)] + keys[:, j]
    uh, inv, counts = torch.unique(h, return_inverse=True, return_counts=True)
    first = torch.full((uh.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(keys.shape[0],
                                               device=keys.device), "amin")
    reps = keys[first]
    if not bool((keys == reps[inv]).all()):  # a hash shared by two words
        reps, counts = torch.unique(keys, dim=0, return_counts=True)
    for row, c in zip(reps.cpu().tolist(), counts.cpu().tolist()):
        w = _decode(row)
        out[w] = out.get(w, 0) + int(c)


def counts(path: str, device: str, block_bytes: int = BLOCK_BYTES,
           cut_at_whitespace: bool = True) -> dict[bytes, int]:
    """Every word of the file with its count."""
    out: dict[bytes, int] = {}
    carry = np.empty(0, np.uint8)
    with open(path, "rb") as f:
        while True:
            raw = np.frombuffer(f.read(block_bytes), np.uint8)
            end = not raw.size
            buf = np.concatenate([carry, raw]) if carry.size else raw
            if not buf.size:
                break
            cut = buf.size
            if cut_at_whitespace and not end:
                cut = 0
                for span in (1 << 16, buf.size):  # the tail first
                    pos = np.flatnonzero(np.isin(buf[-span:], _WS))
                    if pos.size:
                        cut = buf.size - min(span, buf.size) + int(pos[-1]) + 1
                        break
            carry = buf[cut:].copy()
            if cut:
                _count_block(torch.from_numpy(buf[:cut].copy()).to(device),
                             out)
            if end:
                break
    return out


def top_k(ref: dict[bytes, int], k: int) -> list[tuple[bytes, int]]:
    """The ``k`` largest counts, ties by word ascending."""
    return sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def read_counts(path: Path) -> dict[bytes, int] | None:
    """A ``word count`` per line file as a dict; None if it is malformed."""
    out: dict[bytes, int] = {}
    try:
        for line in Path(path).read_bytes().splitlines():
            word, _, c = line.rpartition(b" ")
            if word in out:
                return None
            out[word] = int(c)
    except (OSError, ValueError):
        return None
    return out


def read_top(path: Path) -> list[tuple[bytes, int]] | None:
    try:
        rows = [line.rpartition(b" ")
                for line in Path(path).read_bytes().splitlines()]
        return [(w, int(c)) for w, _, c in rows]
    except (OSError, ValueError):
        return None


def numbers(answer: dict | None, top: list | None, ref: dict,
            ref_top: list) -> dict:
    """How far one job's written answer lies from the reference's:

    - ``words_wrong``: words whose count differs from the reference's,
      with the words that are missing and those that should not be there;
    - ``topk_wrong``: places of the top-k list that differ from the
      reference's (word or count), and the places it lacks or adds.
    A file that cannot be read counts every word, or every place, wrong."""
    if answer is None:
        words_wrong = len(ref) + 1
    else:
        keys = ref.keys() | answer.keys()
        words_wrong = sum(ref.get(w) != answer.get(w) for w in keys)
    if top is None:
        topk_wrong = len(ref_top) + 1
    else:
        topk_wrong = (sum(a != b for a, b in zip(top, ref_top))
                      + abs(len(top) - len(ref_top)))
    return {"words_wrong": float(words_wrong),
            "topk_wrong": float(topk_wrong)}


def expected(cfg: dict, dataset: dict, device: str):
    """The reference's answer: every word's count and the top-k."""
    ref = counts(dataset["path"], device)
    return ref, top_k(ref, int(cfg["job_params"]["top_k"]))


def judge(cfg: dict, dataset: dict, want, outputs: list[Path],
          device: str) -> dict:
    """The worst reading over the jobs' written answers against ``want``:
    each output path is a ``final_result.txt`` with its ``top_k.txt``
    beside it."""
    ref, ref_top = want
    worst: dict = {}
    seen: set[bytes] = set()
    for path in outputs:
        path = Path(path)
        top_path = path.with_name("top_k.txt")
        raw = path.read_bytes() if path.is_file() else b"\0missing"
        raw += b"\0" + (top_path.read_bytes() if top_path.is_file()
                        else b"\0missing")
        if raw in seen:
            continue
        seen.add(raw)
        for name, v in numbers(read_counts(path), read_top(top_path), ref,
                               ref_top).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def check(cfg: dict, dataset: dict, outputs: list[Path],
          device: str) -> dict:
    return judge(cfg, dataset, expected(cfg, dataset, device), outputs,
                 device)


def write_answer(out_dir: Path, name: str, result: dict[bytes, int],
                 k: int) -> Path:
    """Write counts as a job does (``word count`` lines sorted by word)
    with the top-k beside them."""
    path = Path(out_dir) / name
    path.write_bytes(b"".join(w + b" " + str(c).encode() + b"\n"
                              for w, c in sorted(result.items())))
    (Path(out_dir) / "top_k.txt").write_bytes(
        b"".join(w + b" " + str(c).encode() + b"\n"
                 for w, c in top_k(result, k)))
    return path


def control_outputs(cfg: dict, dataset: dict, out_dir: Path,
                    device: str) -> list[Path]:
    """The control's answer, written where a job writes its own."""
    params = cfg["job_params"]
    result = counts(dataset["path"], device,
                    block_bytes=int(params["chunk_bytes"]),
                    cut_at_whitespace=False)
    return [write_answer(out_dir, cfg["output"], result,
                         int(params["top_k"]))]
