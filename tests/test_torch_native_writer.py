"""The word count's native write path (``NativeDictionary.write_counts``,
``runtime/csrc/device_dict.cpp`` ``dd_write_counts``) on the CPU: rows
backed by the device map's native dictionary are looked up, sorted,
formatted and written in one call, byte-identical to the Python
``write_final_result`` over the same rows; every other input keeps the
Python path; errors raise what the Python path raises, and the file's
atomic replace holds either way."""

import numpy as np
import pytest

from map_oxidize_tpu_torch.io.writer import write_final_result
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs.metrics import MetricsRegistry
from map_oxidize_tpu_torch.obs.trace import Tracer
from map_oxidize_tpu_torch.ops.hashing import HashDictionary, moxt64_bytes
from map_oxidize_tpu_torch.runtime.device_dict import NativeDictionary
from map_oxidize_tpu_torch.runtime.driver import LazyCounts

I64_MAX = 2**63 - 1


def _obs() -> Obs:
    obs = Obs(registry=MetricsRegistry(), tracer=Tracer(enabled=False))
    obs.registry.count("device_map/write_rows", 0)
    return obs


def _native(words, hashes=None, obs=None) -> NativeDictionary:
    """A native dictionary from columns, each word under its hash."""
    if hashes is None:
        hashes = [moxt64_bytes(w) for w in words]
    d = NativeDictionary(obs)
    d._add_arrays(np.array(hashes, np.uint64),
                  np.array([len(w) for w in words], np.int64),
                  b"".join(words))
    return d


def _random_words(rng, n, lo, hi, alphabet):
    alphabet = np.frombuffer(alphabet, np.uint8)
    words = {rng.choice(alphabet, int(rng.integers(lo, hi + 1))).tobytes()
             for _ in range(n)}
    return sorted(words, key=lambda w: moxt64_bytes(w))  # not in byte order


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    az = bytes(range(97, 123))
    if name == "random_az":
        words = _random_words(rng, 3000, 1, 12, az)
    elif name == "past_a_block":  # more than the 4 MiB of one write
        words = _random_words(rng, 400_000, 9, 14, az)
    elif name == "prefixes":
        words = [b"ab", b"abc", b"a", b"abcd", b"b", b"abcdefgh",
                 b"abcdefghi", b"abcdefghijklmnop", b"abcdefghijklmnopq",
                 b"ba", b"aa"]
    elif name == "shared_8_and_16":
        words = ([b"abcdefgh" + s for s in (b"", b"a", b"b", b"ab", b"zz")]
                 + [b"abcdefghijklmnop" + s
                    for s in (b"", b"a", b"b", b"ba", b"a" * 30, b"\x00")]
                 + [b"abcdefghijklmnoq", b"abcdefgg"])
    elif name == "longer_than_16":
        words = _random_words(rng, 500, 17, 300, az + b"AZ09.-_")
        words.append(b"k" * (5 << 20))  # past one block, written alone
    elif name == "high_and_nul_bytes":
        words = [b"a", b"a\x00", b"a\x00b", b"\x00", b"\x00\x00", b"\xff",
                 b"\x80a", b"\x7f", b"a\xff", b"a\x80" * 12, b"a\x80" * 9,
                 b"\xc3\xa9t\xc3\xa9", b"\xff" * 20]
        words += _random_words(rng, 500, 1, 20, bytes(range(256)))
        words = list(dict.fromkeys(words))
    elif name == "bigrams":
        words = [b"the cat", b"the", b"the cab", b"thecat", b"the catalog",
                 b"a b", b"a", b"ab", b"the cats",
                 b"of the", b"of"]
    elif name == "extreme_counts":
        words = [b"zero", b"one", b"max", b"minus", b"min", b"ten"]
        return words, [0, 1, I64_MAX, -1, -2**63, 10]
    elif name == "single_row":
        words = [b"alone"]
    elif name == "zero_rows":
        words = []
    else:
        raise KeyError(name)
    return words, rng.integers(0, 10**12, len(words)).tolist()


CASES = ("random_az", "past_a_block", "prefixes", "shared_8_and_16",
         "longer_than_16", "high_and_nul_bytes", "bigrams",
         "extreme_counts", "single_row", "zero_rows")


@pytest.mark.parametrize("case", CASES)
def test_native_bytes_equal_the_python_writer(case, tmp_path):
    words, counts = _case(case)
    obs = _obs()
    d = _native(words, obs=obs)
    k64 = np.array([moxt64_bytes(w) for w in words], np.uint64)
    items = LazyCounts(k64, np.array(counts, np.int64), d).items()
    assert items.write_native is not None
    native, python = tmp_path / "native.txt", tmp_path / "python.txt"
    n = write_final_result(str(native), items)
    assert n == write_final_result(str(python), list(zip(words, counts)))
    assert n == len(words)
    assert native.read_bytes() == python.read_bytes()
    assert obs.registry.counters["device_map/write_rows"] == len(words)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "native.txt", "python.txt"]


def test_a_hash_missing_from_the_dictionary_raises_key_error(tmp_path):
    d = _native([b"one", b"two"])
    gone = moxt64_bytes(b"three")
    k64 = np.array([moxt64_bytes(b"one"), gone], np.uint64)
    out = tmp_path / "out.txt"
    with pytest.raises(KeyError) as err:
        write_final_result(str(out), LazyCounts(k64, np.ones(2, np.int64),
                                                d).items())
    assert err.value.args == (gone,)
    with pytest.raises(KeyError):  # as the Python path's lookup raises
        d.lookup(gone)
    assert list(tmp_path.iterdir()) == []


def test_two_hashes_of_one_word_raise_runtime_error(tmp_path):
    d = _native([b"same", b"same", b"other"], hashes=[1, 2, 3])
    counts = LazyCounts(np.array([3, 1, 2], np.uint64),
                        np.array([5, 6, 7], np.int64), d)
    message = "readback found 2 distinct words for 3 live keys"
    with pytest.raises(RuntimeError, match=message):
        write_final_result(str(tmp_path / "out.txt"), counts.items())
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match=message):  # the Python path
        dict(counts.items())


@pytest.mark.parametrize("source", ["list", "dict_items", "hash_dictionary",
                                    "float_counts"])
def test_other_rows_take_the_python_path(source, tmp_path):
    """Nothing but integer counts over a native dictionary takes the
    native path: the counter stays 0, and the bytes are the same."""
    words = [b"beta", b"alpha", b"gamma"]
    counts = [2, 30, 1]
    obs = _obs()
    native = _native(words, obs=obs)
    k64 = np.array([moxt64_bytes(w) for w in words], np.uint64)
    if source == "list":
        rows = list(LazyCounts(k64, np.array(counts), native).items())
    elif source == "dict_items":
        rows = dict(zip(words, counts)).items()
    elif source == "hash_dictionary":
        hd = HashDictionary()
        for w in words:
            hd.add(moxt64_bytes(w), w)
        rows = LazyCounts(k64, np.array(counts, np.int64), hd).items()
        assert rows.write_native is None
    else:
        rows = LazyCounts(k64, np.array(counts, np.float64), native).items()
        assert rows.write_native is None
    out = tmp_path / "out.txt"
    assert write_final_result(str(out), rows) == 3
    assert out.read_bytes() == b"alpha 30\nbeta 2\ngamma 1\n"
    assert obs.registry.counters["device_map/write_rows"] == 0


@pytest.mark.parametrize("path", ["native", "python"])
def test_the_replace_is_atomic(path, tmp_path):
    """An existing file is replaced whole; a write that raises leaves it
    as it was; no temporary file stays behind."""
    words = [b"x", b"y"]
    d = _native(words)
    k64 = np.array([moxt64_bytes(w) for w in words], np.uint64)
    out = tmp_path / "final_result.txt"
    out.write_bytes(b"old contents, longer than the new rows\n" * 100)
    good = LazyCounts(k64, np.array([4, 5], np.int64), d).items()
    write_final_result(str(out), good if path == "native" else list(good))
    assert out.read_bytes() == b"x 4\ny 5\n"
    if path == "native":  # raises inside the native call
        bad = LazyCounts(np.array([k64[0], moxt64_bytes(b"absent")],
                                  np.uint64),
                         np.array([4, 5], np.int64), d).items()
        with pytest.raises(KeyError):
            write_final_result(str(out), bad)
    else:  # raises while the rows are written
        with pytest.raises(ValueError):
            write_final_result(str(out), [(b"x", 4), (b"y", "five")])
    assert out.read_bytes() == b"x 4\ny 5\n"
    assert [p.name for p in tmp_path.iterdir()] == ["final_result.txt"]
