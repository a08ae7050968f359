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

#: the kernel's tile (bytes per block) and bytes per thread, from its source
TILE = tdt.source_layout()["tile"]
PER_THREAD = tdt.source_layout()["bytes_per_thread"]

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
    tt = tdt.DeviceTokenizer(n, out_keys, device="cpu", fetch_keys=fetch,
                             ngram=ngram)
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
    tt = tdt.DeviceTokenizer(n, 1 << 14, device="cpu")
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
    for tok in (jdt.DeviceTokenizer(4096, out_keys=64),
                tdt.DeviceTokenizer(4096, out_keys=64, device="cpu")):
        packed = np.asarray(tok.map_chunk_device(chunk)[-1])
        n_unique, n_dropped, _ = packed[:3].astype(np.int64).tolist()
        assert (n_unique, n_dropped) == (200, 136)


def test_out_keys_and_fetch_keys_are_clamped():
    tok = tdt.DeviceTokenizer(2048, out_keys=1 << 16, device="cpu",
                              fetch_keys=1 << 20)
    assert tok.max_tokens == 1025
    assert tok.out_keys == tok.fetch_keys == 1025
    u_hi, *_, packed = tok.map_chunk_device(b"a b c")
    assert u_hi.shape == (1025,) and packed.shape == (3 + 3 * 1025,)


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_at_matches_the_host_key_format(ngram):
    chunk = b"The  quick\tbrown\nFOX jumps"
    assert jdt.ngram_at(chunk, 0, ngram) == tdt.ngram_at(chunk, 0, ngram)
    assert tdt.ngram_at(chunk, 5, 2) == b"quick brown"


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_at_reads_a_slot_view_as_the_jax_package_reads_bytes(ngram):
    """The dictionary build reads its keys from a view of the chunk in its
    staging slot: every start (mid-token, on whitespace, at and past the
    end, each whitespace byte) gives the JAX package's key of the bytes."""
    chunk = (b"The  quick\tbrown\nFOX\r\njumps\x0bOVER\x0cthe lazy  dog. "
             b"\t\n end")
    slot = np.full(len(chunk) + 16, 32, np.uint8)
    slot[:len(chunk)] = np.frombuffer(chunk, np.uint8)
    view = memoryview(slot).cast("B")[:len(chunk)]
    for start in range(len(chunk) + 2):
        want = jdt.ngram_at(chunk, start, ngram)
        assert tdt.ngram_at(view, start, ngram) == want, start
        assert tdt.ngram_at(chunk, start, ngram) == want, start
        if ngram == 1:
            assert tdt.token_at(view, start) == jdt.token_at(chunk, start)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no kernel"):
        tdt.tokenize_compact(torch.zeros(8, dtype=torch.uint8,
                                         device="meta"), 5)


def test_device_tokenizer_without_a_device_needs_a_card():
    """``device=None`` is the CUDA card, as in every entry point of the
    port: without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert tdt.DeviceTokenizer(4096).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdt.DeviceTokenizer(4096)


# --- the kernel's decomposition, modelled in numpy --------------------------

_U32 = 0xFFFFFFFF
_IDENTITY = (1, 0, 1, 0, 0, -1)


def _compose(left, right):
    """``right o left`` of two scan states ``(a1, c1, a2, c2, ends,
    last_start)``, u32 maps ``x -> a x + c``, as the kernel's
    ``combine``."""
    a1, c1, a2, c2, e, last = left
    b1, d1, b2, d2, f, last_r = right
    return (b1 * a1 & _U32, (b1 * c1 + d1) & _U32, b2 * a2 & _U32,
            (b2 * c2 + d2) & _U32, e + f, last_r if last_r >= 0 else last)


def _kernel_model(arr: np.ndarray, max_tokens: int, per: int, threads: int):
    """``tokenize_compact.cu``'s arithmetic over a padded chunk: threads of
    ``per`` bytes, tiles of ``threads`` threads.

    Each thread walks its bytes once by Horner's rule (reset by a space),
    staging a row at each token end with its local hashes and start, and
    has the state ``(a, c)`` per hash with ``a`` = P^per if it holds no
    space, else 0.  Tile aggregates compose in tile order into each tile's
    exclusive prefix (what the look-back yields), the thread states in
    thread order within the tile; a row whose token began before its
    thread, ending at its byte k, takes ``P^(k+1) * h_in + c_local`` and
    the carried start.  Each tile's share of the padding rows must cover
    them once.  Returns the kernel's outputs as numpy arrays."""
    n = arr.shape[0]
    tile = per * threads
    size = max(1, -(-n // tile)) * tile
    b = np.full(size, 32, np.uint8)
    b[:n] = arr
    nsp = ~np.isin(b, np.frombuffer(b" \t\n\r\x0b\x0c", np.uint8))
    starts = nsp & ~np.concatenate([[False], nsp[:-1]])
    ends = nsp & ~np.concatenate([nsp[1:], [False]])
    v = np.where((b >= 65) & (b <= 90), b + 32, b).astype(np.uint32) + 1
    n_threads = size // per
    nsp_t, starts_t, ends_t, v_t = (x.reshape(n_threads, per)
                                    for x in (nsp, starts, ends, v))
    pos = np.arange(size).reshape(n_threads, per)
    c = [np.zeros(n_threads, np.uint32), np.zeros(n_threads, np.uint32)]
    begun = np.full(n_threads, -1, np.int64)
    staged = []  # (position, thread, k, local h1, local h2, local start)
    for k in range(per):
        for h, p in enumerate((tdt.P1, tdt.P2)):
            c[h] = np.where(nsp_t[:, k], c[h] * np.uint32(p) + v_t[:, k],
                            np.uint32(0))
        begun = np.where(starts_t[:, k], pos[:, k], begun)
        for t in np.nonzero(ends_t[:, k])[0].tolist():
            staged.append((t * per + k, t, k, int(c[0][t]), int(c[1][t]),
                           int(begun[t])))
    whole = nsp_t.all(axis=1)
    last = np.where(starts_t.any(axis=1),
                    pos[:, 0] + per - 1 - np.argmax(starts_t[:, ::-1], 1), -1)
    state = [(pow(tdt.P1, per, 1 << 32) if whole[t] else 0, int(c[0][t]),
              pow(tdt.P2, per, 1 << 32) if whole[t] else 0, int(c[1][t]),
              int(ends_t[t].sum()), int(last[t])) for t in range(n_threads)]
    tile_prefix = _IDENTITY
    carry_in = []  # the state before each thread
    tile_ends = []  # (ends before the tile, ends in it)
    for j in range(size // tile):
        in_tile = _IDENTITY
        for t in range(j * threads, (j + 1) * threads):
            carry_in.append(_compose(tile_prefix, in_tile))
            in_tile = _compose(in_tile, state[t])
        tile_ends.append((tile_prefix[4], in_tile[4]))
        tile_prefix = _compose(tile_prefix, in_tile)
    rows = []
    for _, t, k, h1, h2, st in sorted(staged):
        if st < 0:
            x = carry_in[t]
            h1 = (pow(tdt.P1, k + 1, 1 << 32) * x[1] + h1) & _U32
            h2 = (pow(tdt.P2, k + 1, 1 << 32) * x[3] + h2) & _U32
            st = x[5]
        if h1 == h2 == _U32:
            h2 -= 1
        rows.append((h1, h2, st))
    n_tokens = tile_prefix[4]
    assert n_tokens == len(rows)
    t_hi = np.zeros(max_tokens, np.uint32)
    t_lo = np.zeros(max_tokens, np.uint32)
    t_start = np.zeros(max_tokens, np.int32)
    kept = rows[:max_tokens]
    if kept:
        t_hi[:len(kept)], t_lo[:len(kept)], t_start[:len(kept)] = zip(*kept)
    # the padding, a range per tile between the slots that the bytes up to
    # its start and up to its end rule out, and a slice per tile of the
    # slots no chunk of n bytes reaches: every padding row written once
    def bound(ends, left):
        return min(max_tokens, ends + (max(left, 0) + 1) // 2)

    writes = np.zeros(max_tokens, np.int64)
    n_tiles = len(tile_ends)
    reach = bound(0, n)
    for j, (before, inside) in enumerate(tile_ends):
        for a, b in ((bound(before + inside, n - (j + 1) * tile),
                      bound(before, n - j * tile)),
                     (reach + (max_tokens - reach) * j // n_tiles,
                      reach + (max_tokens - reach) * (j + 1) // n_tiles)):
            writes[a:b] += 1
    assert not writes[:len(kept)].any()
    assert (writes[len(kept):] == 1).all()
    t_hi[len(kept):] = t_lo[len(kept):] = _U32
    t_start[len(kept):] = 2**31 - 1
    return t_hi, t_lo, t_start, n_tokens


def _model_chunks(per: int, threads: int):
    """Chunks for the model at one thread and tile width: random text,
    tokens straddling every thread and tile edge, tokens ending on a
    thread's last byte and starting on its first, tokens longer than a
    tile, one token filling the chunk, a row every other byte, ragged
    lengths."""
    tile = per * threads
    n = 5 * tile + 37
    straddle = np.full(n, 32, np.uint8)
    for e in range(per, n, per):
        straddle[e - 2:e + 1] = np.frombuffer(b"aBc", np.uint8)
    for e in range(tile, n, tile):
        straddle[e - 4:e + 3] = np.frombuffer(b"TiLeEdG", np.uint8)
    bounds = np.full(n, ord("q"), np.uint8)
    bounds[per - 1:n // 2:per] = 32
    bounds[n // 2::per] = 32
    long = np.full(n, ord("L"), np.uint8)
    long[tile + tile // 2::tile + tile // 2 + 3] = 32
    dense = np.full(n, 32, np.uint8)
    dense[1::2] = ord("d")
    rng = np.random.default_rng(per * threads)
    text = np.frombuffer(_random_text(per + threads, n, b"abXY\x00\xff ,\n"),
                         np.uint8)
    yield "text", text
    yield "straddle", straddle
    yield "thread bounds", bounds
    yield "longer than a tile", long
    yield "one token", np.full(n, ord("w"), np.uint8)
    yield "dense", dense
    for m in (1, per - 1, per + 1, tile - 1, tile + 1, 2 * tile + per // 2):
        yield f"ragged {m}", rng.choice(
            np.frombuffer(b"ab c\t", np.uint8), size=m)


@pytest.mark.parametrize("per,threads", [(16, 4), (16, 8), (32, 4), (32, 8),
                                         (32, 256)])
def test_kernel_decomposition_is_bit_equal_to_plain(per, threads):
    """The kernel's arithmetic (per-thread Horner states with ``a`` in {0,
    P^per}, tile aggregates composed in tile order, the carry-in formula)
    against ``tokenize_compact_plain`` at two thread widths and three tile
    sizes (the last the kernel's own: 32 bytes x 256 threads), with all
    row slots and with fewer slots than tokens."""
    for name, arr in _model_chunks(per, threads):
        chunk = torch.from_numpy(arr.copy())
        n_tok = int(tdt.tokenize_compact_plain(chunk, 1)[3])
        for max_tokens in {arr.shape[0] // 2 + 1, max(1, n_tok - 1),
                           max(1, n_tok // 2 + 3)}:
            want = tdt.tokenize_compact_plain(chunk, max_tokens)
            got = _kernel_model(arr, max_tokens, per, threads)
            assert np.array_equal(got[0], _u32(want[0])), (name, max_tokens)
            assert np.array_equal(got[1], _u32(want[1])), (name, max_tokens)
            assert np.array_equal(got[2], want[2].numpy()), (name,
                                                             max_tokens)
            assert got[3] == int(want[3]), (name, max_tokens)

