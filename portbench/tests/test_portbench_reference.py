"""The plain references agree with ``run_job`` on the CPU at a tiny size
of each configuration, and count what their documents say."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.reference import kmeans as ref_km
from portbench.reference import wordcount as ref_wc
from portbench.tests.conftest import run_cell


@pytest.mark.parametrize("cell,numbers", [
    ("kmeans.sift1m-ivf4096",
     {"centroids_moved"}),
    ("wordcount.hibench-large.device", {"words_wrong", "topk_wrong"}),
])
def test_reference_agrees_with_run_job(cell, numbers, capsys):
    res = run_cell(cell, capsys)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) <= numbers and res["checks"]
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    if cell.startswith("wordcount"):
        assert all(c["value"] == 0 for c in res["checks"].values())


def test_word_rules(tmp_path):
    text = (b"Alpha beta\tALPHA\r\nbeta\x0bgamma\x0cdelta  alpha "
            b"internationalisations internationalisation\n\n"
            + b"x" * 40 + b" " + b"X" * 40 + b"\n")
    path = tmp_path / "t.txt"
    path.write_bytes(text)
    want = {}
    for w in text.split():
        want[w.lower()] = want.get(w.lower(), 0) + 1
    assert ref_wc.counts(str(path), "cpu") == want
    # blocks far smaller than the file: no word is split at a cut
    assert ref_wc.counts(str(path), "cpu", block_bytes=7) == want
    # cut blindly, words across the cuts come out in pieces
    assert ref_wc.counts(str(path), "cpu", block_bytes=7,
                         cut_at_whitespace=False) != want


def test_hash_collision_falls_back_to_exact_rows(tmp_path, monkeypatch):
    path = tmp_path / "t.txt"
    path.write_bytes(b"one two three two three three four\n")
    monkeypatch.setattr(ref_wc, "_MIX", (0,))  # every word hashes alike
    assert ref_wc.counts(str(path), "cpu") == {
        b"one": 1, b"two": 2, b"three": 3, b"four": 1}


def test_top_k_ties_by_word():
    assert ref_wc.top_k({b"b": 2, b"a": 2, b"c": 3, b"d": 1}, 3) == [
        (b"c", 3), (b"a", 2), (b"b", 2)]


def test_kmeans_reference_follows_lloyd(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 256, (500, 8)).astype(np.float32)
    path = tmp_path / "p.npy"
    np.save(path, pts)
    c = pts[:5].astype(np.float64)
    for _ in range(4):
        d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
        cid = d2.argmin(1)
        for j in range(5):
            if (cid == j).any():
                c[j] = pts[cid == j].astype(np.float64).mean(0)
    got = ref_km.fit(str(path), 5, 4, "cpu")
    np.testing.assert_allclose(got, c, rtol=1e-12)


def test_kmeans_numbers_read_an_answer(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 256, (400, 4)).astype(np.float32)
    path = tmp_path / "p.npy"
    np.save(path, pts)
    ref = ref_km.fit(str(path), 6, 3, "cpu")
    assign = ref_km.assignments(str(path), ref, "cpu")
    same = ref_km.numbers(ref.astype(np.float32), ref, str(path), assign,
                          "cpu")
    assert same["centroids_moved"] == 0 and same["assign_mismatch"] == 0
    bad = ref_km.numbers(np.zeros_like(ref), ref, str(path), assign, "cpu")
    assert bad["centroids_moved"] == 1.0 and bad["centroid_gap_max"] > 0.5
    assert ref_km.numbers(np.zeros((2, 2)), ref, str(path), assign,
                          "cpu")["centroid_gap_max"] == float("inf")
