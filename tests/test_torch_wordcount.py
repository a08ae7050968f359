"""Word count through the port (``backend='cpu'``) against the JAX package:
byte-identical ``final_result.txt`` and the same top-k, plus the capacity
error and engine state carried across between the two packages."""

import collections

import numpy as np
import pytest
import torch

from map_oxidize_tpu.api import SumReducer as JaxSumReducer
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.engine import DeviceReduceEngine as JaxEngine
from map_oxidize_tpu.workloads.wordcount import WordCountMapper as JaxMapper
from map_oxidize_tpu_torch import cli
from map_oxidize_tpu_torch.api import SumReducer
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.convert import (
    engine_state_from_jax,
    engine_state_to_numpy,
)
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.engine import (
    CapacityError,
    DeviceReduceEngine,
)

torch.set_num_threads(2)


def _mixed_corpus(seed=31, vocab=400, lines=600) -> bytes:
    """Zipf-ish words in random case, some with punctuation attached."""
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghij"), size=rng.integers(1, 8)))
             for _ in range(vocab)]
    out = []
    for _ in range(lines):
        toks = []
        for i in rng.zipf(1.3, size=rng.integers(0, 14)):
            w = words[min(int(i), vocab) - 1]
            w = "".join(ch.upper() if rng.random() < 0.3 else ch for ch in w)
            toks.append(w + rng.choice(["", "", "", ",", ".", "!", "'s"]))
        out.append((" " if rng.random() < 0.8 else "\t").join(toks))
    return ("\n".join(out) + "\n").encode()


UNICODE = ("Straße STRASSE straße naïve NAÏVE Ωmega ωMEGA ΣΊΣΥΦΟΣ σίσυφος\n"
           "Ünïcödé ünïcödé — «quoted» 東京 東京　東京\n") * 40

CASES = {
    "mixed_case_punct": (_mixed_corpus(), {}),
    "empty": (b"", {}),
    "unicode": (UNICODE.encode(), {"tokenizer": "unicode"}),
    "capacity_growth": (_mixed_corpus(32, vocab=3000, lines=1500),
                        {"batch_size": 128, "initial_key_capacity": 16,
                         "chunk_bytes": 4096}),
}


def _both(tmp_path, data: bytes, **kw):
    inp = tmp_path / "corpus.txt"
    inp.write_bytes(data)
    out_t, out_j = tmp_path / "t.txt", tmp_path / "j.txt"
    common = dict(input_path=str(inp), metrics=False, **kw)
    r = run_job(JobConfig(output_path=str(out_t), backend="cpu", **common))
    j = jax_run_job(JaxJobConfig(output_path=str(out_j), backend="cpu",
                                 num_shards=1, mapper="python", **common))
    return r, j, out_t.read_bytes(), out_j.read_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_final_result_byte_identical_to_jax(tmp_path, case):
    data, kw = CASES[case]
    r, j, got, want = _both(tmp_path, data, **kw)
    assert got == want
    assert r.top == j.top
    tok = (data.decode().lower().split() if kw.get("tokenizer") == "unicode"
           else data.lower().split())
    oracle = collections.Counter(tok)
    assert len(r.counts) == len(oracle)
    if case == "capacity_growth":
        assert r.metrics["capacity_rows"] >= len(oracle) > 16


def test_capacity_error_when_key_capacity_too_small(tmp_path):
    inp = tmp_path / "corpus.txt"
    inp.write_bytes(_mixed_corpus(33))
    cfg = JobConfig(input_path=str(inp), output_path="", backend="cpu",
                    key_capacity=64, batch_size=256, metrics=False)
    with pytest.raises(CapacityError, match="key_capacity=64"):
        run_job(cfg)


def test_dispatch_batch_and_cli_give_the_same_bytes(tmp_path):
    data, _ = CASES["mixed_case_punct"]
    _, _, _, want = _both(tmp_path, data, batch_size=64, chunk_bytes=2048)
    out = tmp_path / "cli.txt"
    rc = cli.main(["wordcount", str(tmp_path / "corpus.txt"), "--output",
                   str(out), "--backend", "cpu", "--batch-size", "64",
                   "--dispatch-batch", "3", "-q"])
    assert rc == 0
    assert out.read_bytes() == want


def _finalized(engine):
    hi, lo, vals, n = engine.finalize()
    hi, lo, vals = (np.asarray(a) for a in (hi, lo, vals))
    live = ~((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF))
    keys = (hi[live].astype(np.uint64) << 32) | lo[live]
    return dict(zip(keys.tolist(), vals[live].tolist())), int(n)


def test_engine_state_carries_across_both_ways():
    """Half the corpus folds in the JAX engine, its export_state crosses to
    the port, the port folds the rest: the result is the all-JAX result.
    And the port's state crosses back into a JAX engine unchanged."""
    data = _mixed_corpus(34, vocab=1500, lines=800)
    lines = data.splitlines(keepends=True)
    halves = [b"".join(lines[:400]), b"".join(lines[400:])]
    mapper = JaxMapper(use_native=False)
    outs = [mapper.map_chunk(h[i:i + 3000])
            for h in halves for i in range(0, len(h), 3000)]
    split = sum(1 for i in range(0, len(halves[0]), 3000))
    jcfg = JaxJobConfig(input_path="unused", output_path="", backend="cpu",
                        batch_size=256, initial_key_capacity=64)
    tcfg = JobConfig(input_path="unused", output_path="", backend="cpu",
                     batch_size=256, initial_key_capacity=64)

    whole = JaxEngine(jcfg, JaxSumReducer())
    for o in outs:
        whole.feed(o)
    want = _finalized(whole)

    first = JaxEngine(jcfg, JaxSumReducer())
    for o in outs[:split]:
        first.feed(o)
    first.flush()
    port = DeviceReduceEngine(tcfg, SumReducer())
    port.import_state(engine_state_from_jax(first.export_state(), "cpu"))
    for o in outs[split:]:
        port.feed(o)
    port.flush()
    back = engine_state_to_numpy(port.export_state())
    assert _finalized(port) == want

    ref = whole.export_state()
    for key in ("acc_hi", "acc_lo", "acc_vals", "ovf", "n_unique"):
        assert back[key].dtype == ref[key].dtype, key
    jax_again = JaxEngine(jcfg, JaxSumReducer())
    jax_again.import_state(back)
    assert _finalized(jax_again) == want


def test_engine_top_k_matches_jax():
    """The engine's device top-k (value desc, ties to the lower key) over
    the same fed rows, with k past the live rows."""
    mapper = JaxMapper(use_native=False)
    outs = [mapper.map_chunk(_mixed_corpus(35, vocab=50, lines=200))]
    jcfg = JaxJobConfig(input_path="unused", output_path="", backend="cpu",
                        batch_size=512)
    tcfg = JobConfig(input_path="unused", output_path="", backend="cpu",
                     batch_size=512)
    j, t = JaxEngine(jcfg, JaxSumReducer()), DeviceReduceEngine(
        tcfg, SumReducer())
    for o in outs:
        j.feed(o)
        t.feed(o)
    for k in (5, 600):
        for a, b in zip(t.top_k(k), j.top_k(k)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_host_copies_match_the_jax_package(tmp_path):
    """The port's copies of the hash and the splitters give the JAX
    package's bits and cuts."""
    from map_oxidize_tpu.io import splitter as jsplit
    from map_oxidize_tpu.ops.hashing import moxt64_bytes as jax_moxt64
    from map_oxidize_tpu_torch.io import splitter as tsplit
    from map_oxidize_tpu_torch.ops.hashing import moxt64_bytes

    rng = np.random.default_rng(36)
    for n in list(range(40)) + [1000]:
        b = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert moxt64_bytes(b) == jax_moxt64(b)
    inp = tmp_path / "c.txt"
    inp.write_bytes(_mixed_corpus(37))
    for cb in (64, 1000, 1 << 20):
        assert tsplit.plan_chunks(str(inp), cb) == jsplit.plan_chunks(
            str(inp), cb)
        assert ([bytes(c) for c in tsplit.iter_chunks(str(inp), cb)]
                == [bytes(c) for c in jsplit.iter_chunks(str(inp), cb)])
        assert (list(tsplit.iter_chunks_capped(str(inp), cb))
                == list(jsplit.iter_chunks_capped(str(inp), cb)))
