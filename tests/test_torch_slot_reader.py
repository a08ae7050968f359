"""The device map reads each chunk straight into its staging slot
(``io/splitter.py`` ``iter_chunks_into``): the same chunks at the same
offsets as ``iter_chunks_capped`` for every cut (a tail scan, the whole
window, a hard split) and resume offset; the slot's bytes past a chunk are
spaces; the dictionary is built from a slot before the slot is refilled;
and the job writes the host map's bytes (on the CPU)."""

from collections import Counter

import numpy as np
import pytest
import torch

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.io.splitter import (
    _CUT_TAIL,
    iter_chunks_capped,
    iter_chunks_into,
)
from map_oxidize_tpu_torch.runtime import device_map as dm
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.pipeline import StagingRing

torch.set_num_threads(2)

CB = 3 * _CUT_TAIL + 5  # windows longer than the tail scan


def _capped(path, cb, start=0):
    out, off = [], start
    for c in iter_chunks_capped(str(path), cb, start):
        out.append((off, len(c), bytes(c)))
        off += len(c)
    return out


def _into(path, cb, start=0):
    """``(offset, length, bytes)`` of each chunk read into two rotating
    buffers (longer than a window, filled with junk), with the reader's
    carries and fallbacks."""
    bufs = [np.full(cb + 9, 0xAB, np.uint8) for _ in range(2)]
    out, carries, fallbacks, off = [], [], 0, start
    for f in iter_chunks_into(str(path), cb, lambda s: bufs[s % 2], start):
        assert f.buf is bufs[len(out) % 2]
        out.append((off, f.length, bytes(f.data)))
        carries.append(f.carry_in)
        fallbacks += f.cut_fallback
        off += f.length
    return out, carries, fallbacks


def _filler(rng, n, ws=b" \n\t"):
    """``n`` bytes of short tokens separated by the bytes of ``ws``."""
    out = bytearray()
    while len(out) < n:
        out += b"t%d" % rng.integers(0, 10 ** 6)
        out.append(ws[rng.integers(0, len(ws))])
    return bytes(out[:n])


def _solid(n):
    return b"x" * n


def _case(name, rng):
    """``(file bytes, windows that must fall back)``: the windows of each
    case are laid out in ``CB``-byte steps from offset 0."""
    if name in ("space", "tab", "newline"):
        ws = {"space": b" ", "tab": b"\t", "newline": b"\n"}[name]
        # every window's last whitespace is ``ws``, 10 bytes from its end
        w = _solid(CB - 11) + ws + _solid(10)
        return w + ws + w[:CB - 50] + ws + _solid(40) + b" end\n", 0
    if name in ("vt_outside_tail", "ff_outside_tail", "space_outside_tail"):
        ws = {"vt_outside_tail": b"\x0b", "ff_outside_tail": b"\x0c",
              "space_outside_tail": b" "}[name]
        # the window's one whitespace byte lies before the tail it scans
        pos = CB - _CUT_TAIL - 100
        return _solid(pos) + ws + _solid(CB - pos - 1) + b" z", 1
    if name in ("vt_in_tail", "cr_in_tail"):
        ws = {"vt_in_tail": b"\x0b", "cr_in_tail": b"\r"}[name]
        pos = CB - 30
        return _solid(pos) + ws + _solid(CB - pos - 1) + b" z", 0
    if name == "hard_split":  # a whitespace-free run of 2.5 windows
        return _solid(5 * CB // 2) + b" tail", 2
    if name == "exact_multiple":
        data = _filler(rng, 4 * CB - 1) + b"\n"
        return data, 0
    if name == "shorter_than_a_window":
        return _filler(rng, CB // 3), 0
    if name == "empty":
        return b"", 0
    if name == "mixed":  # every ASCII whitespace byte, many windows
        return _filler(rng, 12 * CB, ws=b" \t\n\r\x0b\x0c"), 0
    raise KeyError(name)


CASES = ("space", "tab", "newline", "vt_outside_tail", "ff_outside_tail",
         "space_outside_tail", "vt_in_tail", "cr_in_tail", "hard_split",
         "exact_multiple", "shorter_than_a_window", "empty", "mixed")


@pytest.mark.parametrize("name", CASES)
def test_reader_cuts_where_the_capped_splitter_cuts(tmp_path, name):
    """Chunks, offsets and lengths equal ``iter_chunks_capped``'s from the
    file's start; each chunk's carry is the previous window's tail; only
    windows whose cut needs more than the tail scan fall back."""
    data, want_fallbacks = _case(name, np.random.default_rng(len(name)))
    path = tmp_path / "c.bin"
    path.write_bytes(data)
    want = _capped(path, CB)
    got, carries, fallbacks = _into(path, CB)
    assert got == want
    assert b"".join(c for _, _, c in got) == data
    assert carries == ([0] + [CB - n for _, n, _ in want])[:len(want)]
    assert fallbacks == want_fallbacks


@pytest.mark.parametrize("cb", [64, 1000, CB, 5 * CB])
def test_reader_resumes_at_any_cut(tmp_path, cb):
    """From a fresh run's cut offsets (the snapshot's resume offsets), the
    chunks equal the capped splitter's resumed from the same offset, and
    the tail of the fresh run."""
    data, _ = _case("mixed", np.random.default_rng(cb))
    path = tmp_path / "c.bin"
    path.write_bytes(data)
    fresh = _capped(path, cb)
    assert len(fresh) > 2
    for i in sorted({1, len(fresh) // 2, len(fresh) - 1}):
        start = fresh[i][0]
        got, _, _ = _into(path, cb, start)
        assert got == _capped(path, cb, start) == fresh[i:]


def test_reader_rejects_a_buffer_shorter_than_a_window(tmp_path):
    path = tmp_path / "c.bin"
    path.write_bytes(b"a b c " * 100)
    with pytest.raises(ValueError, match="buffer of 63 bytes"):
        next(iter_chunks_into(str(path), 64, lambda s: bytearray(63)))


def test_host_slot_refuses_a_slot_not_yet_released():
    ring = StagingRing(2, 16, 1, torch.uint8, torch.device("cpu"))
    ring.host_slot(0)[:] = 1
    assert ring.start_copy(0, 16) == 0
    ring.host_slot(1)
    with pytest.raises(RuntimeError, match="overrun: block 2"):
        ring.host_slot(2)
    ring.release(0, 0)
    assert ring.acquire(0).numpy().ravel().tolist() == [1] * 16
    assert ring.host_slot(2) is not None


def _slot_corpus(seed=11, lines=9000):
    """One token per line, so every whitespace byte is a newline and the
    device map's chunks are the host map's; every line brings a new key,
    some of them long, so a chunk can be much shorter than the one its
    slot held before."""
    rng = np.random.default_rng(seed)
    toks = []
    for i in range(lines):
        r = rng.random()
        if r < 0.025:
            toks.append(b"L%d" % i + b"q" * int(rng.integers(500, 1500)))
        elif r < 0.5:
            toks.append(b"n%dZ" % i)  # new in this chunk
        else:
            toks.append(b"w%d" % rng.integers(0, 50))
    return b"\n".join(toks) + b"\n"


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("workload", ["wordcount", "bigram"])
def test_slots_are_reused_cleanly_through_the_job(tmp_path, monkeypatch,
                                                  workload, num_shards):
    """Through the whole job, on one device and on three shards (groups of
    three chunks, one slot a group): each chunk's dictionary step reads
    its bytes intact in its slot, before the group two on refills the
    slot; no stale byte of an earlier chunk is counted; the counts and the
    written bytes are the host map's."""
    path = tmp_path / "c.txt"
    path.write_bytes(_slot_corpus())
    cb = 1 << 13
    chunks = [c for _, _, c in _capped(path, cb)]
    assert len(chunks) > 8
    assert len(chunks) % 3  # a short last group of three
    assert min(map(len, chunks[:-1])) < cb - 600  # a long carry
    events = []
    real_slot = StagingRing.host_slot
    real_dict = dm._DictBuilder.process_packed

    def host_slot(self, seq):
        events.append(("fill", seq))
        return real_slot(self, seq)

    def process_packed(self, chunk, packed, overflow):
        events.append(("dict", bytes(chunk)))
        return real_dict(self, chunk, packed, overflow)

    monkeypatch.setattr(StagingRing, "host_slot", host_slot)
    monkeypatch.setattr(dm._DictBuilder, "process_packed", process_packed)
    kw = dict(input_path=str(path), backend="cpu", chunk_bytes=cb,
              metrics=False)
    r = run_job(JobConfig(output_path=str(tmp_path / "dev.txt"),
                          mapper="device", device_chunk_keys=4096,
                          num_shards=num_shards, **kw), workload)
    dicts = [e[1] for e in events if e[0] == "dict"]
    assert dicts == chunks
    for seq in range(len(chunks)):
        i = events.index(("dict", chunks[seq]))
        assert ("fill", seq // num_shards + 2) not in events[:i]
    run_job(JobConfig(output_path=str(tmp_path / "host.txt"),
                      mapper="native", **kw), workload)
    assert (tmp_path / "dev.txt").read_bytes() == \
        (tmp_path / "host.txt").read_bytes()
    if workload == "wordcount":
        assert r.counts == dict(Counter(path.read_bytes().lower().split()))
    m = r.metrics
    assert m["chunks"] == len(chunks)
    assert m["device_map/cut_fallbacks"] == 0
    assert m["device_map/carry_bytes"] == sum(cb - len(c)
                                              for c in chunks[:-1])


def test_job_counts_its_cut_fallbacks(tmp_path):
    """Windows whose one whitespace lies before the tail scan, and a hard
    split, are counted; the job's counts are the capped splitter's."""
    data = (_case("space_outside_tail", None)[0] + b"\n"
            + _case("hard_split", None)[0] + b"\n")
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    r = run_job(JobConfig(input_path=str(path), backend="cpu",
                          mapper="device", chunk_bytes=CB,
                          device_chunk_keys=256, output_path="",
                          metrics=False), "wordcount")
    chunks = list(iter_chunks_capped(str(path), CB))
    assert r.counts == dict(Counter(t.lower() for c in chunks
                                    for t in c.split()))
    _, _, fallbacks = _into(path, CB)
    assert r.metrics["device_map/cut_fallbacks"] == fallbacks >= 3


def test_an_empty_file_has_both_counters(tmp_path):
    path = tmp_path / "e.txt"
    path.write_bytes(b"")
    r = run_job(JobConfig(input_path=str(path), backend="cpu",
                          mapper="device", chunk_bytes=1 << 12,
                          output_path="", metrics=False), "wordcount")
    assert r.metrics["chunks"] == 0
    assert r.metrics["device_map/cut_fallbacks"] == 0
    assert r.metrics["device_map/carry_bytes"] == 0
