"""The generators of both cells: seeded, and writing only where told."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest

from portbench.bench import Bench
from portbench.run import merged
from portbench.tests.conftest import CHECKOUT, TINY

CELLS = {"kmeans.sift1m-ivf4096": "points.npy",
         "wordcount.hibench-large.device": "corpus.txt"}


def _make(cell: str, seed: int, out: Path) -> tuple[dict, str]:
    bench = Bench(CHECKOUT)
    cfg = merged(bench.config(bench.cell(cell)["config"]), TINY[cell])
    out.mkdir()
    info = bench.generator(cfg["dataset"]["generator"]).generate(
        cfg["dataset"], seed, out, "cpu")
    return info, hashlib.sha256(Path(info["path"]).read_bytes()).hexdigest()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_one_seed_same_bytes_two_seeds_differ(cell, tmp_path):
    a, ha = _make(cell, 2**31 + 3, tmp_path / "a")
    b, hb = _make(cell, 2**31 + 3, tmp_path / "b")
    c, hc = _make(cell, 2**31 + 4, tmp_path / "c")
    assert ha == hb and ha != hc
    for out, info in (("a", a), ("b", b), ("c", c)):
        assert [p.name for p in (tmp_path / out).iterdir()] == [CELLS[cell]]
        assert Path(info["path"]).parent == tmp_path / out


def test_points_are_integers_in_range(tmp_path):
    info, _ = _make("kmeans.sift1m-ivf4096", 5, tmp_path / "p")
    pts = np.load(info["path"])
    spec = TINY["kmeans.sift1m-ivf4096"]["dataset"]
    assert pts.shape == (spec["n"], 128) and pts.dtype == np.float32
    assert pts.min() >= 0 and pts.max() <= 255
    assert np.array_equal(pts, np.round(pts))
    assert not np.signbit(pts).any()


def test_text_has_the_random_text_writer_layout(tmp_path):
    from portbench.generators import random_text_writer as rtw

    info, _ = _make("wordcount.hibench-large.device", 5, tmp_path / "t")
    bench = Bench(CHECKOUT)
    spec = merged(bench.config("hibench-wordcount-large"),
                  TINY["wordcount.hibench-large.device"])["dataset"]
    raw = Path(info["path"]).read_bytes()
    assert len(raw) == info["bytes"] <= spec["total_bytes"]
    assert raw.endswith(b"\n")
    words = rtw.vocabulary(spec)
    assert len(words) == 1000
    assert len({w.lower() for w in words}) == 1000
    assert 9 < np.mean([len(w) for w in words]) < 11
    assert any(w[:1].isupper() for w in words)
    vocab = set(words)
    longest = 0
    for line in raw.split(b"\n")[:-1]:
        key, value = line.split(b"\t")
        k, v = key.split(b" "), value.split(b" ")
        assert 5 <= len(k) <= 9 and 20 <= len(v) <= 99
        assert set(k) <= vocab and set(v) <= vocab
        longest = max(longest, len(line) + 1)
    assert len(raw) > spec["total_bytes"] - longest
