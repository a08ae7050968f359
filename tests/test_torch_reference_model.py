"""The port's golden oracle (``workloads/reference_model.py``) against the
JAX package's: ``wordcount_model`` and ``top_k_model`` equal on seeded
corpora in ``ascii`` and ``unicode`` modes, and a port word count's
``final_result.txt`` and top-k equal to the oracle's."""

import numpy as np
import pytest

from map_oxidize_tpu.workloads import reference_model as jax_model
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.workloads import reference_model as model


def _chunks(seed, n_chunks=5, lines=120):
    """Chunks of mixed-case words, some non-ASCII, some with punctuation,
    Unicode spaces and empty lines among them."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefgHIJKL") + ["é", "ß", "Ω", "ü", "İ"]
    seps = [" ", "  ", "\t", "\n", " ", " ", ", "]
    words = ["".join(rng.choice(alphabet, size=rng.integers(1, 6)))
             for _ in range(150)]
    chunks = []
    for _ in range(n_chunks):
        parts = []
        for _ in range(lines):
            for i in rng.zipf(1.4, size=rng.integers(0, 9)):
                parts.append(words[min(int(i), len(words)) - 1])
                parts.append(str(rng.choice(seps)))
            parts.append("\n")
        chunks.append("".join(parts).encode())
    return chunks


@pytest.mark.parametrize("mode", ["ascii", "unicode"])
@pytest.mark.parametrize("seed", range(4))
def test_models_equal_jax(seed, mode):
    chunks = _chunks(seed)
    counts = model.wordcount_model(chunks, mode)
    assert counts == jax_model.wordcount_model(chunks, mode)
    assert sum(counts.values()) > 0
    for k in (1, 10, 1000):
        assert model.top_k_model(counts, k) == jax_model.top_k_model(
            counts, k)


def test_ties_break_by_word():
    counts = model.wordcount_model([b"b a c b a c d"])
    assert model.top_k_model(counts, 3) == [(b"a", 2), (b"b", 2), (b"c", 2)]


@pytest.mark.parametrize("mode", ["ascii", "unicode"])
def test_a_port_word_count_equals_the_oracle(tmp_path, mode):
    corpus = b"".join(_chunks(9))
    path = tmp_path / "c.txt"
    path.write_bytes(corpus)
    out = tmp_path / "out.txt"
    res = run_job(JobConfig(input_path=str(path), backend="cpu",
                            output_path=str(out), tokenizer=mode,
                            metrics=False, top_k=7), "wordcount")
    counts = model.wordcount_model([corpus], mode)
    lines = out.read_bytes().splitlines()
    assert len(lines) == len(counts)
    got = {}
    for line in lines:
        word, _, n = line.rpartition(b" ")
        got[word] = int(n)
    assert got == dict(counts)
    assert [(w, c) for w, c in res.top] == model.top_k_model(counts, 7)
