"""The device map's native dictionary builder (``runtime/device_dict.py``,
``runtime/csrc/device_dict.cpp``) on the CPU: one native call per chunk
held to the Python reference it replaced (``ngram_at`` + a
``HashDictionary`` add per key), its 64-bit collision check on forged
packed rows, in a snapshot resume and in a job, and its packaging."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from map_oxidize_tpu.native import build as jax_build
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.native import build
from map_oxidize_tpu_torch.ops import device_tokenize
from map_oxidize_tpu_torch.ops.device_tokenize import ngram_at
from map_oxidize_tpu_torch.ops.hashing import (
    HashDictionary,
    moxt64_bytes,
    split_u64,
)
from map_oxidize_tpu_torch.runtime import device_dict, run_job
from map_oxidize_tpu_torch.runtime.checkpoint import _arrays_to_dict
from map_oxidize_tpu_torch.runtime.device_map import _DictBuilder

ROOT = Path(__file__).resolve().parent.parent
WS = b" \t\n\r\x0b\x0c"  # every byte the device splits tokens at


def _vocab(rng, n=300) -> list[bytes]:
    """Words of 1-40 bytes: letters of both cases, digits, punctuation and
    bytes >= 0x80 (left as they are), never a whitespace byte; some longer
    than 16 bytes, some the same word in another case."""
    alphabet = np.array([b for b in range(33, 256) if b not in WS],
                        np.uint8)
    words = []
    for i in range(n):
        size = int(rng.integers(17, 41) if i % 5 == 0
                   else rng.integers(1, 9))
        words.append(rng.choice(alphabet, size).tobytes())
    return words + [w.upper() for w in words[:40]] + [
        w.swapcase() for w in words[40:80]]


def _chunk(rng, vocab, n_tokens: int) -> bytes:
    """Tokens from ``vocab`` between runs of 1-3 whitespace bytes, the last
    token cut by the chunk's end."""
    ws = np.frombuffer(WS, np.uint8)
    parts = []
    for i in rng.integers(0, len(vocab), n_tokens):
        parts.append(vocab[i])
        parts.append(rng.choice(ws, int(rng.integers(1, 4))).tobytes())
    cut = b"Tail-OF-a-token-cut-here"[:int(rng.integers(5, 24))]
    return b"".join(parts[:-1]) + cut


def _keys(chunk: bytes, ngram: int):
    """The device's view of a chunk: each distinct n-gram key's hash (in
    ascending order) with its first start, and the chunk's n-gram rows."""
    b = np.frombuffer(chunk, np.uint8)
    ws = np.isin(b, np.frombuffer(WS, np.uint8))
    starts = np.flatnonzero(~ws & np.concatenate([[True], ws[:-1]]))
    rows = starts[:max(len(starts) - (ngram - 1), 0)]
    first = {}
    for s in rows.tolist():
        first.setdefault(moxt64_bytes(ngram_at(chunk, s, ngram)), s)
    h = np.array(sorted(first), np.uint64)
    rep = np.array([first[x] for x in h.tolist()], np.uint32)
    return h, rep, len(rows)


def _packed(h, rep, n_rows: int, fetch_keys: int):
    """The packed row ``(nu, ndrop, ntok, hi[f], lo[f], rep[f])`` and the
    overflow fetch of the keys past it."""
    f = fetch_keys
    hi, lo = split_u64(h)
    nu = len(h)
    row = np.zeros(3 + 3 * f, np.uint32)
    row[:3] = nu, 0, n_rows
    m = min(nu, f)
    row[3:3 + m], row[3 + f:3 + f + m] = hi[:m], lo[:m]
    row[3 + 2 * f:3 + 2 * f + m] = rep[:m]
    fetched = []

    def overflow(n):
        fetched.append(n)
        return hi[:n], lo[:n], rep[:n]
    return row, overflow, fetched


def _as(chunk: bytes, form: str):
    """The chunk as bytes, or as the device map hands it over: a view of
    a space-padded staging slot, bounded by the chunk's length."""
    if form == "bytes":
        return chunk
    slot = np.full(len(chunk) + 4096, 32, np.uint8)
    slot[:len(chunk)] = np.frombuffer(chunk, np.uint8)
    return memoryview(slot)[:len(chunk)]


@pytest.mark.parametrize("form", ["bytes", "slot"])
@pytest.mark.parametrize("window", ["packed", "overflow"])
@pytest.mark.parametrize("ngram", [1, 2])
def test_the_native_builder_is_the_python_loop(ngram, window, form):
    """Four chunks in sequence: the same dictionary (bytes and insertion
    order), the same ``(nu, new)`` per chunk, the same ``records_in``."""
    rng = np.random.default_rng(1000 * ngram + len(window) + len(form))
    vocab = _vocab(rng)
    fetch = 1 << 12 if window == "packed" else 16
    builder = _DictBuilder(1 << 20, fetch, ngram)
    ref = HashDictionary()
    records = 0
    for _ in range(4):
        chunk = _chunk(rng, vocab, 700)
        h, rep, n_rows = _keys(chunk, ngram)
        row, overflow, fetched = _packed(h, rep, n_rows, fetch)
        got = builder.process_packed(_as(chunk, form), row, overflow)
        before = len(ref)
        for x, r in zip(h.tolist(), rep.tolist()):
            ref.add(x, ngram_at(chunk, r, ngram))
        assert got == (len(h), len(ref) - before)
        assert fetched == ([len(h)] if len(h) > fetch else [])
        records += n_rows
    d = builder.dictionary
    assert builder.records_in == records
    assert len(d) == d.upper_bound() == len(ref)
    assert d.materialized() == ref.materialized()
    for a, b in zip(d.to_arrays(), ref.to_arrays()):
        np.testing.assert_array_equal(a, b)
    some = h[:5].tolist()
    assert [d.lookup(x) for x in some] == [ref.lookup(x) for x in some]
    assert d.get(0, b"none") == b"none"
    with pytest.raises(KeyError):
        d.lookup(0)


def _collision(case, first: bytes, second: bytes) -> None:
    """Feed builders forged rows that give one hash to ``first`` and to
    ``second``, as ``case`` says; it is to raise."""
    h = np.array([0x1234_5678_9ABC_DEF0], np.uint64)

    def feed(builder, chunk):
        row, overflow, _ = _packed(h, np.zeros(1, np.uint32), 1, 4)
        builder.process_packed(chunk, row, overflow)

    a = _DictBuilder(1 << 10, 4)
    if case == "one_chunk":
        two = np.repeat(h, 2)
        reps = np.array([0, len(first) + 1], np.uint32)
        row, overflow, _ = _packed(two, reps, 2, 4)
        a.process_packed(first + b" " + second, row, overflow)
    elif case in ("two_chunks", "long"):
        feed(a, first)
        feed(a, second.upper())
    elif case == "snapshot":
        feed(a, first)
        resumed = _DictBuilder(1 << 10, 4)
        # what load_snapshot gives and _set_dict takes in
        resumed.dictionary.update(_arrays_to_dict(*a.dictionary.to_arrays()))
        feed(resumed, second)
    elif case == "union":
        b = _DictBuilder(1 << 10, 4)
        feed(a, first)
        feed(b, second)
        a.dictionary.update(b.dictionary)


@pytest.mark.parametrize("case", ["one_chunk", "two_chunks", "long",
                                  "snapshot", "union"])
def test_a_hash_given_to_two_tokens_raises(case):
    """Within a chunk, across chunks, past 16 bytes (the first 16 equal),
    across a snapshot resume and in the sharded union:
    ``HashDictionary``'s error, naming both tokens and the hash."""
    first, second = (b"a-token-past-16-bytes-x", b"a-token-past-16-bytes-y"
                     ) if case == "long" else (b"alpha", b"beta")
    with pytest.raises(ValueError) as e:
        _collision(case, first, second)
    assert str(e.value) == (f"64-bit hash collision: {first!r} and "
                            f"{second!r} both hash to 0x123456789abcdef0")


def test_a_repeated_key_in_another_case_is_no_collision():
    """The stored key is lowercased, so ``ALPHA`` under alpha's hash is the
    same key: no error, nothing new."""
    b = _DictBuilder(1 << 10, 4)
    h = np.array([moxt64_bytes(b"alpha")], np.uint64)
    for chunk, new in ((b"alpha", 1), (b"ALPHA", 0), (b"AlPhA\t", 0)):
        row, overflow, _ = _packed(h, np.zeros(1, np.uint32), 1, 4)
        assert b.process_packed(chunk, row, overflow) == (1, new)
    assert dict(b.dictionary.items()) == {int(h[0]): b"alpha"}


@pytest.mark.parametrize("hashes, lens, ok", [
    ([1, 2], [2, 2], True),     # the lengths sum to the blob's size
    ([1, 2], [5, -1], False),   # ... but one is negative
    ([1, 2], [2, 3], False),    # the blob is too short
    ([1], [2, 2], False),       # more lengths than hashes
])
def test_restored_columns_are_checked_before_the_native_call(hashes, lens,
                                                             ok):
    """A snapshot's columns come from a file: they are read only if they
    agree with each other."""
    d = HashDictionary()
    d.add_arrays(np.array(hashes, np.uint64), np.array(lens, np.int64),
                 b"abcd")
    native = _DictBuilder(1 << 10, 4).dictionary
    if ok:
        native.update(d)
        assert dict(native.items()) == {1: b"ab", 2: b"cd"}
    else:
        with pytest.raises(ValueError, match="columns differ"):
            native.update(d)


def _device_hash(word: bytes):
    t_hi, t_lo, _, _ = device_tokenize.tokenize_compact_plain(
        torch.from_numpy(np.frombuffer(word + b"    ", np.uint8).copy()), 4)
    return t_hi[0], t_lo[0]


def test_a_device_map_job_aborts_on_a_device_hash_collision(tmp_path,
                                                            monkeypatch):
    """On the CPU backend, with the device hash patched so that ``beta``
    hashes as ``alpha`` does: the first chunk stores alpha, the second
    holds only beta, and the job raises instead of merging the two."""
    cb = 1 << 12
    first = (b"alpha filler " * 400)[:cb - 16] + b"\n"
    path = tmp_path / "c.txt"
    path.write_bytes(first.ljust(cb, b" ") + b"beta other words\n" * 50)
    a_hi, a_lo = _device_hash(b"alpha")
    b_hi, b_lo = _device_hash(b"beta")
    real = device_tokenize.tokenize_compact

    def colliding(chunk, max_tokens):
        t_hi, t_lo, t_start, n = real(chunk, max_tokens)
        hit = (t_hi == b_hi) & (t_lo == b_lo)
        return (torch.where(hit, a_hi, t_hi), torch.where(hit, a_lo, t_lo),
                t_start, n)

    monkeypatch.setattr(device_tokenize, "tokenize_compact", colliding)
    config = JobConfig(input_path=str(path), backend="cpu", mapper="device",
                       chunk_bytes=cb, device_chunk_keys=1024, metrics=False,
                       output_path=str(tmp_path / "out.txt"))
    with pytest.raises(ValueError, match="b'alpha' and b'beta' both hash"):
        run_job(config, "wordcount")
    assert not (tmp_path / "out.txt").exists()


def test_the_dictionary_source_ships_and_builds_on_its_own(monkeypatch,
                                                           tmp_path):
    """The C++ source is package data beside ``native/csrc``, untouched;
    its library's name carries the digest and is neither native map
    library's name; a forced build replaces a file already on disk."""
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["map_oxidize_tpu_torch.runtime"] == ["csrc/*.cpp"]
    pkg = ROOT / "map_oxidize_tpu_torch" / "runtime"
    assert [p.name for p in pkg.glob("csrc/*.cpp")] == ["device_dict.cpp"]
    name = Path(device_dict.library_path()).name
    assert re.fullmatch(r"libmoxt_device_dict-[0-9a-f]{16}\.so", name)
    assert name not in (Path(build.library_path()).name,
                        Path(jax_build._SO).name)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    so = Path(device_dict._compile())
    assert so.parent == tmp_path and so.name == name
    so.write_bytes(b"not a library")
    assert device_dict._compile() == str(so)      # a current file is reused
    assert Path(device_dict._compile(force=True)).read_bytes()[:4] == \
        b"\x7fELF"
