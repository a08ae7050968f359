"""The port's device tokenizer against the JAX package's on the CPU: the
torch form of ``tokenize_hash`` + ``_compact_tokens`` (the plain version of
the ``tokenize_compact`` kernel), and the whole per-chunk map
(``tokenize_count_core``: rows, dedup, n-grams, ``packed``) bit-equal to
JAX ``tokenize_count_chunk`` for words and bigrams, over the JAX package's
test cases plus tokens on the kernel's tile and thread edges; the (word,
count) mapping equals a Counter; dropped unique keys are reported."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_oxidize_tpu.ops import device_tokenize as jdt
from map_oxidize_tpu_torch.ops import device_tokenize as tdt

torch.set_num_threads(2)

#: the kernel's tile (bytes per block) and bytes per thread
TILE, PER_THREAD = 4096, 16

CASES = [
    b"",
    b"   \t\n  ",
    b"hello",
    b"The quick Brown fox JUMPS over the lazy dog, the the THE",
    b"a b c d e f g h a b c a b a",
    b"tabs\tand\nnewlines\rand\x0bvertical\x0cfeeds mixed  double  spaces",
    b"punct, stays! attached. to? words; always: (parens) [too]",
    b"x" * 1000 + b" " + b"y" * 3 + b" end",
    "unicode café naïve 中文 words".encode("utf-8"),
    b"trailing space ",
    b" leading",
    b"A" * 512,
    b"a \x00b \x00ab ab b",  # NUL bytes are token bytes, not separators
    b"@[`{ AZaz \x7f\xff\x80 \x1f\x0e\x08",  # the bytes beside A-Z and \t-\r
]


def _edges(n: int) -> bytes:
    """Short tokens straddling every tile edge and every 37th thread edge,
    a token at byte 0 and one running into the chunk's last byte."""
    a = np.full(n, 32, np.uint8)
    a[0] = ord("S")
    for e in range(TILE, n, TILE):
        a[e - 3:e + 2] = np.frombuffer(b"TiLeX", np.uint8)
    for e in range(PER_THREAD, n, PER_THREAD * 37):
        a[e - 1:e + 1] = np.frombuffer(b"zq", np.uint8)
    a[-4:] = np.frombuffer(b"tail", np.uint8)
    return a.tobytes()


def _random_text(seed: int, n: int, alphabet=b"abcdeXYZ,. \n\t") -> bytes:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).tobytes()


#: (chunk bytes, chunk window) pairs beyond CASES: tile edges, a chunk
#: that ends inside a token, one token filling the window, a ragged window
EXTRA = [
    (_edges(3 * TILE + 100), 3 * TILE + 100),
    (_random_text(1, 2 * TILE, b"ab ") + b"endsinatoken", 2 * TILE + 12),
    (b"w" * (TILE + 5), TILE + 5),
    (_random_text(2, TILE - 1), TILE + 333),
    (_random_text(3, 20000), 1 << 15),
]


def _inputs():
    for i, c in enumerate(CASES):
        yield f"case{i}", c, 4096
    for i, (c, n) in enumerate(EXTRA):
        yield f"extra{i}", c, n


INPUTS = list(_inputs())


def _jax_compact(chunk: bytes, n: int, max_tokens: int):
    arr = jnp.asarray(jdt.pad_chunk(chunk, n))
    tables = [jnp.asarray(t) for t in jdt._power_tables(n)]
    h1, h2, tok_start, _, end = jdt.tokenize_hash(arr, *tables)
    return [np.asarray(x) for x in jdt._compact_tokens(
        h1, h2, tok_start, end, max_tokens)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name,chunk,n", INPUTS, ids=[i[0] for i in INPUTS])
def test_plain_compact_equals_jax_tokenize_hash_and_compact(name, chunk, n):
    max_tokens = n // 2 + 1
    want = _jax_compact(chunk, n, max_tokens)
    arr = torch.from_numpy(tdt.pad_chunk(chunk, n).copy())
    t_hi, t_lo, t_start, n_tok = tdt.tokenize_compact(arr, max_tokens)
    assert t_hi.dtype == t_lo.dtype == t_start.dtype == torch.int32
    assert np.array_equal(_u32(t_hi), want[0])
    assert np.array_equal(_u32(t_lo), want[1])
    assert np.array_equal(t_start.numpy(), want[2])
    assert int(n_tok) == int(want[3]) == len(chunk.split())


def test_compact_drops_rows_past_max_tokens_but_counts_them():
    chunk = b"a b c d e f g"
    want = _jax_compact(chunk, 64, 4)
    got = tdt.tokenize_compact_plain(
        torch.from_numpy(tdt.pad_chunk(chunk, 64).copy()), 4)
    assert np.array_equal(_u32(got[0]), want[0])
    assert np.array_equal(got[2].numpy(), want[2])
    assert int(got[3]) == int(want[3]) == 7


def test_the_kernel_hash_is_horner_over_the_token():
    """The identity the kernel rests on: ``P^e * (S[e] - S[s-1])`` is
    Horner's rule over the lowered token's ``b + 1`` (mod 2^32)."""
    chunk = _random_text(4, 3000, b"abcXYZ\x00\xff,. ")
    got = tdt.tokenize_compact_plain(
        torch.from_numpy(tdt.pad_chunk(chunk, 4096).copy()), 2049)
    toks = chunk.split()
    assert int(got[3]) == len(toks)
    for i, tok in enumerate(toks):
        h = []
        for p in (tdt.P1, tdt.P2):
            x = 0
            for b in tok.lower():
                x = (x * p + b + 1) & 0xFFFFFFFF
            h.append(x)
        if h == [0xFFFFFFFF, 0xFFFFFFFF]:
            h[1] -= 1
        assert [_u32(got[0])[i], _u32(got[1])[i]] == h


def test_mulu32_matches_numpy_wraparound():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64).astype(np.uint32)
    a[:3] = b[:3] = 0xFFFFFFFF
    got = tdt._mulu32(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), a * b)


@pytest.mark.parametrize("ngram", [1, 2])
@pytest.mark.parametrize("name,chunk,n", INPUTS, ids=[i[0] for i in INPUTS])
def test_count_core_is_bit_equal_to_jax(name, chunk, n, ngram):
    out_keys, fetch = 1024, 256
    jt = jdt.DeviceTokenizer(n, out_keys, fetch_keys=fetch, ngram=ngram)
    tt = tdt.DeviceTokenizer(n, out_keys, fetch_keys=fetch, ngram=ngram)
    want = [np.asarray(x) for x in jt.map_chunk_device(chunk)]
    got = [x.numpy() for x in tt.map_chunk_device(chunk)]
    names = ("u_hi", "u_lo", "counts", "reps", "packed")
    for nm, w, g in zip(names, want, got):
        g = g.view(np.uint32) if w.dtype == np.uint32 else g
        assert w.dtype == g.dtype, nm
        assert np.array_equal(w, g), nm


@pytest.mark.parametrize("name,chunk,n", INPUTS, ids=[i[0] for i in INPUTS])
def test_device_counts_match_python(name, chunk, n):
    """Parity on the (token -> count) mapping, rebuilt through the
    representative offsets as the job driver does."""
    tt = tdt.DeviceTokenizer(n, 1 << 14)
    u_hi, u_lo, counts, reps, packed = tt.map_chunk_device(chunk)
    nu, n_dropped, n_tokens = packed.numpy()[:3].tolist()
    assert n_dropped == 0
    got = {}
    keys = set()
    for h, l, c, r in zip(_u32(u_hi)[:nu].tolist(), _u32(u_lo)[:nu].tolist(),
                          counts[:nu].tolist(), reps[:nu].tolist()):
        assert (h, l) not in keys
        keys.add((h, l))
        word = tdt.token_at(chunk, r)
        assert word not in got
        got[word] = c
    want = Counter(chunk.lower().split())
    assert got == dict(want)
    assert n_tokens == sum(want.values())


def test_out_keys_overflow_detected():
    chunk = b" ".join(b"w%d" % i for i in range(200))
    for tok_cls in (jdt.DeviceTokenizer, tdt.DeviceTokenizer):
        tok = tok_cls(4096, out_keys=64)
        packed = np.asarray(tok.map_chunk_device(chunk)[-1])
        n_unique, n_dropped, _ = packed[:3].astype(np.int64).tolist()
        assert (n_unique, n_dropped) == (200, 136)


def test_out_keys_and_fetch_keys_are_clamped():
    tok = tdt.DeviceTokenizer(2048, out_keys=1 << 16, fetch_keys=1 << 20)
    assert tok.max_tokens == 1025
    assert tok.out_keys == tok.fetch_keys == 1025
    u_hi, *_, packed = tok.map_chunk_device(b"a b c")
    assert u_hi.shape == (1025,) and packed.shape == (3 + 3 * 1025,)


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_at_matches_the_host_key_format(ngram):
    chunk = b"The  quick\tbrown\nFOX jumps"
    assert jdt.ngram_at(chunk, 0, ngram) == tdt.ngram_at(chunk, 0, ngram)
    assert tdt.ngram_at(chunk, 5, 2) == b"quick brown"


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no kernel"):
        tdt.tokenize_compact(torch.zeros(8, dtype=torch.uint8,
                                         device="meta"), 5)
