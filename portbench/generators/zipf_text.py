"""Text for a word-count job whose words follow a Zipf–Mandelbrot law, as
the words of English Wikipedia text do.

Reads the configuration's ``dataset`` section:

- ``total_bytes``: the file holds whole lines up to this many bytes (it
  stops at the last line that fits, so it is short of it by less than a
  line);
- ``zipf_s``, ``zipf_q``: the law.  The word of rank ``r`` (``r >= 1``)
  is drawn with probability ``P(r) = (r + q)^-s / Z`` over every rank,
  ``Z`` the sum over all of them;
- ``head_ranks``: ranks ``1 .. head_ranks`` are drawn by the inverse of
  their cumulative table, built in float64; a draw that falls beyond the
  table takes a rank of the tail in closed form: ``x`` from the density
  ``(x + q)^-s`` on ``[head_ranks + 1/2, inf)``, ``x = (head_ranks + 1/2
  + q) v^(-1/(s - 1)) - q`` with ``v`` uniform on ``(0, 1]``, rounded to
  the nearest rank and held at or under ``max_rank``.  ``Z`` takes the
  tail as the same integral.  Beyond a rank in the millions the integral
  differs from the sum by a share of order ``s(s + 1) / 24 / rank^2``, so
  the distinct count of a job is the law's to well under 1%;
- ``vocab_seed``, ``len_a``, ``len_b``: the word of a rank, the same in
  every run.  Its length is ``floor(len_a + len_b ln(r) + j)``, ``j`` a
  hash of the rank and ``vocab_seed`` uniform on ``[0, 1)``, so a word is
  ``len_a + len_b ln(r)`` letters long on average, and never shorter
  than the rank's digits in base 26.  Its letters are those digits, the
  lowest first, each shifted by a hash of ``vocab_seed`` and the digits
  before it: a bijection of the strings of one length, so two ranks
  never share a word;
- ``para_words_min`` / ``para_words_max``: a line is a paragraph of
  ``[para_words_min, para_words_max]`` words (uniform), separated by one
  space and ended by a newline;
- ``paragraphs_per_batch``: paragraphs made per device call.

Only ``a``-``z``, space and newline occur.  The draws run on ``device``
from one ``torch.Generator`` seeded with the run's seed, so a seed gives
the same bytes on the same kind of device.  The file is synced to disk
before the run goes on.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import torch

_M64 = (1 << 64) - 1
#: 26^1 .. 26^13: a rank below 26^k has at most k digits in base 26
_POW26 = [26 ** k for k in range(1, 14)]


def _signed(x: int) -> int:
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


_C1, _C2 = _signed(0xBF58476D1CE4E5B9), _signed(0x94D049BB133111EB)
_GOLDEN = _signed(0x9E3779B97F4A7C15)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser over int64 (products wrap; the shifts are
    logical, by masking the arithmetic ones)."""
    x = x ^ ((x >> 30) & ((1 << 34) - 1))
    x = x * _C1
    x = x ^ ((x >> 27) & ((1 << 37) - 1))
    x = x * _C2
    return x ^ ((x >> 31) & ((1 << 33) - 1))


def _mix_int(x: int) -> int:
    return int(_mix(torch.tensor([_signed(x)], dtype=torch.int64))[0])


class Law:
    """The rank law and the word of each rank, from a ``dataset`` spec."""

    def __init__(self, spec: dict):
        self.s = float(spec["zipf_s"])
        self.q = float(spec["zipf_q"])
        self.head = int(spec["head_ranks"])
        self.max_rank = int(spec["max_rank"])
        self.len_a = float(spec["len_a"])
        self.len_b = float(spec["len_b"])
        seed = int(spec["vocab_seed"])
        self.len_key = _mix_int(seed * 2 + 1)
        self.spell_key = _mix_int(seed * 2 + 2)
        w = (np.arange(1, self.head + 1, dtype=np.float64) + self.q) ** -self.s
        tail = (self.head + 0.5 + self.q) ** (1 - self.s) / (self.s - 1)
        z = float(w.sum()) + tail
        #: P(r) of the head ranks, its running sum, and the tail's share
        self.p_head = w / z
        self.cdf = np.cumsum(self.p_head)
        self.tail_mass = tail / z
        self.z = z

    def ranks(self, u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
        """The rank of each uniform draw ``u`` (float64 in ``[0, 1)``);
        ``cdf`` is :attr:`cdf` on ``u``'s device."""
        head = torch.searchsorted(cdf, u, right=True) + 1
        v = ((1.0 - u) / self.tail_mass).clamp(min=1e-300)
        x = (self.head + 0.5 + self.q) * v.pow(-1.0 / (self.s - 1)) - self.q
        tail = torch.floor(x.clamp(max=float(self.max_rank)) + 0.5).to(
            torch.int64).clamp(self.head + 1, self.max_rank)
        return torch.where(head > self.head, tail, head)

    def lengths(self, ranks: torch.Tensor) -> torch.Tensor:
        """Letters in the word of each rank."""
        jitter = ((_mix(ranks ^ self.len_key) & ((1 << 53) - 1))
                  .to(torch.float64) * 2.0 ** -53)
        law = torch.floor(self.len_a + self.len_b
                          * torch.log(ranks.to(torch.float64)) + jitter)
        digits = torch.searchsorted(
            torch.tensor(_POW26, dtype=torch.int64, device=ranks.device),
            ranks, right=True) + 1
        return torch.maximum(law.to(torch.int64), digits)

    def spell(self, ranks: torch.Tensor, width: int) -> torch.Tensor:
        """``(n, width)`` uint8: column ``j`` holds letter ``j`` of each
        rank's word (a word of ``L`` letters reads its first ``L``)."""
        out = torch.empty((ranks.shape[0], width), dtype=torch.uint8,
                          device=ranks.device)
        rest = ranks.clone()
        state = torch.full_like(ranks, self.spell_key)
        for j in range(width):
            digit = rest % 26
            rest = rest // 26
            shift = ((state >> 33) & 0x7FFF_FFFF) % 26
            out[:, j] = ((digit + shift) % 26 + 97).to(torch.uint8)
            state = _mix(state + digit + _signed((j + 1) * _GOLDEN))
        return out

    def words(self, ranks) -> list[bytes]:
        """The words of ``ranks`` (for tests and reports)."""
        r = torch.as_tensor(ranks, dtype=torch.int64)
        lens = self.lengths(r)
        mat = self.spell(r, int(lens.max()) if r.numel() else 1).numpy()
        return [mat[i, :n].tobytes() for i, n in enumerate(lens.tolist())]

    def expected_distinct(self, n_words: float) -> float:
        """The law's expected count of distinct words in ``n_words``
        draws: the head's ranks summed, the tail as the integral of
        ``1 - exp(-n P(x))``, in closed form over ``t = n P(x)``."""
        head = float(-np.expm1(n_words * np.log1p(-self.p_head)).sum())
        k = n_words / self.z
        t0 = k * (self.head + 0.5 + self.q) ** -self.s
        # (k^(1/s) / s) * integral_0^t0 (1 - e^-t) t^(-1/s - 1) dt, over
        # ln t on a fine grid (the integrand is t^(-1/s) near 0)
        v = np.linspace(math.log(t0) - 80.0, math.log(t0), 400_001)
        t = np.exp(v)
        f = -np.expm1(-t) * t ** (-1.0 / self.s)
        tail = k ** (1.0 / self.s) / self.s * float(np.trapezoid(f, v))
        return head + tail


def generate(spec: dict, seed: int, out_dir: Path, device: str) -> dict:
    law = Law(spec)
    cdf = torch.from_numpy(law.cdf).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    budget = int(spec["total_bytes"])
    batch = int(spec["paragraphs_per_batch"])
    lo, hi = int(spec["para_words_min"]), int(spec["para_words_max"])
    path = Path(out_dir) / "corpus.txt"
    written = lines = words = 0
    with open(path, "wb") as f:
        while True:
            per_line = torch.randint(lo, hi + 1, (batch,), generator=g,
                                     device=device)
            n = int(per_line.sum())
            u = torch.rand(n, dtype=torch.float64, generator=g,
                           device=device)
            ranks = law.ranks(u, cdf)
            lens = law.lengths(ranks)
            width = int(lens.max()) + 1
            mat = law.spell(ranks, width)
            line = torch.repeat_interleave(
                torch.arange(batch, device=device), per_line)
            last = torch.cumsum(per_line, 0) - 1
            sep = torch.full((n,), ord(" "), dtype=torch.uint8,
                             device=device)
            sep[last] = ord("\n")
            mat[torch.arange(n, device=device), lens] = sep
            cols = torch.arange(width, device=device)
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
            words += int(per_line[:fit].sum())
            if fit < batch:
                break
        f.flush()
        os.fsync(f.fileno())  # the write-back in set-up, not in the window
    return {"path": str(path), "bytes": written, "lines": lines,
            "words": words}
