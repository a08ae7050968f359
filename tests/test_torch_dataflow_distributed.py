"""The port's multi-process dataflow (``parallel/dataflow.py``) on the CPU:
sort, join and sessionize in 2 Gloo processes x 4 local slots of one S=8
mesh, against the port's one-process run and the JAX package's in-process
run at S=8 (and the oracles the JAX package's ``tests/
test_dataflow_distributed.py`` holds its own 2-process runs to).

The sort's parts, concatenated process-major, are the one-process sorted
file byte for byte, also when the sort is forced far past the resident
cap and completes through per-process disk buckets; the join's and the
sessionize's parts cover disjoint hash partitions, so their rows sorted
are the one-process file's.
"""

import numpy as np

import test_torch_distributed as td

DF = dict(chunk_bytes=16 * 512, batch_size=1 << 12, num_shards=8,
          session_gap=400)


def _sort_input(tmp_path, n=6000, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[keys == np.uint64((1 << 64) - 1)] -= np.uint64(1)
    keys[: n // 10] = keys[5]  # a duplicate block: payload order matters
    pay = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    np.save(tmp_path / "recs.npy", np.stack([keys, pay], axis=1))
    return keys, pay


def _parts(out, nproc=2) -> bytes:
    return b"".join(open(f"{out}.part{p}of{nproc}", "rb").read()
                    for p in range(nproc))


def _lines_sorted(blob: bytes) -> bytes:
    return b"".join(sorted(blob.splitlines(keepends=True)))


def _records_sorted(blob: bytes) -> bytes:
    rec = np.frombuffer(blob, np.uint8).reshape(-1, 24)
    order = np.lexsort(rec.T[::-1])
    return rec[order].tobytes()


def test_two_process_sort_process_major_equals_one_process(tmp_path):
    from map_oxidize_tpu_torch.workloads.sort import (
        read_sorted_records,
        sort_model,
    )

    keys, pay = _sort_input(tmp_path)
    out = str(tmp_path / "sorted.bin")
    cfg = dict(DF, input_path=str(tmp_path / "recs.npy"), output_path=out)
    res = td.launch(tmp_path, "sort", cfg)
    assert res[0]["n_rows"] == res[1]["n_rows"] == keys.shape[0]
    assert res[0]["spilled_rows"] == 0
    td.port_single("sort", **dict(cfg, output_path=str(tmp_path / "o")))
    td.jax_single("sort", **dict(cfg, output_path=str(tmp_path / "j")))
    parts = _parts(out)
    assert parts == (tmp_path / "o").read_bytes()
    assert parts == (tmp_path / "j").read_bytes()
    gk, gp = read_sorted_records(str(tmp_path / "o"))
    wk, wp = sort_model(keys, pay)
    assert np.array_equal(gk, wk) and np.array_equal(gp, wp)


def test_two_process_forced_spill_sort_globally_sorted(tmp_path):
    """Far past the resident cap: per-process disk buckets, spill rows
    on BOTH processes summing to the global rows, and the parts still
    concatenate into the one-process file."""
    keys, _pay = _sort_input(tmp_path, seed=4)
    n = keys.shape[0]
    out = str(tmp_path / "sorted.bin")
    cfg = dict(DF, input_path=str(tmp_path / "recs.npy"), output_path=out,
               collect_max_rows=1000)
    res = td.launch(tmp_path, "sort", cfg)
    assert res[0]["n_rows"] == n
    assert res[0]["spilled_rows"] == n   # a replicated global figure
    spills = [r["metrics"]["spill/rows"] for r in res]
    assert all(s > 0 for s in spills) and sum(spills) == n
    td.port_single("sort", **dict(DF, input_path=str(tmp_path / "recs.npy"),
                                  output_path=str(tmp_path / "o")))
    assert _parts(out) == (tmp_path / "o").read_bytes()


def test_two_process_join_matches_one_process(tmp_path):
    from map_oxidize_tpu_torch.workloads.join import join_model

    rng = np.random.default_rng(5)
    na, nb = 3000, 2500
    ka = rng.integers(0, 400, na, dtype=np.uint64)
    pa = rng.integers(0, 1 << 40, na, dtype=np.uint64)
    kb = rng.integers(0, 400, nb, dtype=np.uint64)
    pb = rng.integers(0, 1 << 40, nb, dtype=np.uint64)
    np.save(tmp_path / "a.npy", np.stack([ka, pa], axis=1))
    np.save(tmp_path / "b.npy", np.stack([kb, pb], axis=1))
    out = str(tmp_path / "join.bin")
    cfg = dict(DF, input_path=str(tmp_path / "a.npy"),
               join_input_path=str(tmp_path / "b.npy"), output_path=out)
    res = td.launch(tmp_path, "join", cfg)
    wk, _wa, _wb = join_model(ka, pa, kb, pb)
    for r in res:
        r.pop("metrics")
        r.pop("metric_keys")
    assert res[0] == res[1]
    assert res[0]["n_matches"] == wk.shape[0]
    assert (res[0]["n_left"], res[0]["n_right"]) == (na, nb)
    assert res[0]["n_keys"] == np.unique(np.concatenate([ka, kb])).shape[0]
    td.port_single("join", **dict(cfg, output_path=str(tmp_path / "o")))
    td.jax_single("join", **dict(cfg, output_path=str(tmp_path / "j")))
    parts = _records_sorted(_parts(out))
    assert parts == _records_sorted((tmp_path / "o").read_bytes())
    assert parts == _records_sorted((tmp_path / "j").read_bytes())


def test_two_process_sessionize_matches_one_process(tmp_path):
    from map_oxidize_tpu_torch.workloads.sessionize import sessionize_model

    rng = np.random.default_rng(6)
    ne = 4000
    ek = rng.integers(0, 150, ne, dtype=np.uint64)
    ts = rng.integers(0, 90_000, ne, dtype=np.uint64)
    np.save(tmp_path / "recs.npy", np.stack([ek, ts], axis=1))
    out = str(tmp_path / "sess.txt")
    cfg = dict(DF, input_path=str(tmp_path / "recs.npy"), output_path=out)
    res = td.launch(tmp_path, "sessionize", cfg)
    mk, _ms, _me, _mc = sessionize_model(ek, ts, 400)
    assert res[0]["n_sessions"] == res[1]["n_sessions"] == mk.shape[0]
    assert res[0]["n_events"] == ne
    assert res[0]["n_keys"] == np.unique(ek).shape[0]
    td.port_single("sessionize", **dict(cfg, output_path=str(
        tmp_path / "o")))
    td.jax_single("sessionize", **dict(cfg, output_path=str(
        tmp_path / "j")))
    parts = _lines_sorted(_parts(out))
    assert parts == _lines_sorted((tmp_path / "o").read_bytes())
    assert parts == _lines_sorted((tmp_path / "j").read_bytes())
