"""The port's run ledger (``obs/ledger.py``) against the JAX package's: the
same entry format both ways.  Entries the port appends are read by the
JAX ``read`` and compared by its ``diff_entries``; entries the JAX package
appends are read and diffed by the port; the pure diff/gate/format
functions give equal results on the same entries.  CPU only.
"""

import dataclasses
import json

import numpy as np
import pytest

from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import ledger as jax_ledger
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import Obs
from map_oxidize_tpu_torch.obs import ledger
from map_oxidize_tpu_torch.runtime import run_job

#: the live-plane fields of the port's JobConfig: none of
#: them may change a job's identity (JAX ``_NON_IDENTITY_FIELDS``)
LIVE_FIELDS = ("ledger_dir", "obs_port", "obs_sample_s", "obs_spool",
               "slo_rules", "incident_dir", "profile_dir", "host_sample_hz")


def _corpus(path, seed=3, lines=400):
    rng = np.random.default_rng(seed)
    words = [f"w{i}".encode() for i in range(60)]
    with open(path, "wb") as f:
        for _ in range(lines):
            f.write(b" ".join(words[int(i)]
                              for i in rng.integers(0, 60, 9)) + b"\n")
    return str(path)


def _run(tmp_path, package, name, runs=2, **kw):
    """``runs`` word counts of one corpus appending to one ledger."""
    corpus = _corpus(tmp_path / "c.txt")
    ldir = str(tmp_path / f"ledger_{name}")
    for i in range(runs):
        if package == "port":
            cfg = JobConfig(input_path=corpus, backend="cpu",
                            output_path=str(tmp_path / f"{name}{i}.txt"),
                            num_chunks=3, metrics=False, ledger_dir=ldir,
                            **kw)
            run_job(cfg, "wordcount")
        else:
            cfg = JaxJobConfig(input_path=corpus, num_shards=1,
                               output_path=str(tmp_path / f"{name}{i}.txt"),
                               num_chunks=3, metrics=False, ledger_dir=ldir,
                               **kw)
            jax_run_job(cfg, "wordcount")
    return ldir


def test_port_entries_are_read_and_diffed_by_the_jax_ledger(tmp_path):
    ldir = _run(tmp_path, "port", "t")
    entries = jax_ledger.read(ldir)
    assert len(entries) == 2 == len(ledger.read(ldir))
    assert entries == ledger.read(ldir, "wordcount")
    a, b = entries
    assert a["workload"] == "wordcount" and a["config_hash"] == \
        b["config_hash"]
    ref = jax_ledger.diff_entries(a, b, threshold_pct=1e9)
    assert ref["warnings"] == []
    assert ledger.diff_entries(a, b, threshold_pct=1e9) == ref
    assert any(r[0] == "records_in" or r[0] == "phase/split_s"
               for r in ref["rows"])
    assert jax_ledger.format_diff(a, b, ref) == ledger.format_diff(a, b, ref)


def test_jax_entries_are_read_and_diffed_by_the_port_ledger(tmp_path):
    ldir = _run(tmp_path, "jax", "j")
    entries = ledger.read(ldir)
    assert entries == jax_ledger.read(ldir) and len(entries) == 2
    a, b = entries
    diff = ledger.diff_entries(a, b, threshold_pct=1e9)
    assert diff == jax_ledger.diff_entries(a, b, threshold_pct=1e9)
    assert diff["warnings"] == []
    assert ledger.gate_against_previous(ldir, b, 1e9) == \
        jax_ledger.gate_against_previous(ldir, b, 1e9)


def test_entries_have_the_jax_shape(tmp_path):
    """One word count per package: equal top-level keys (with the same
    ``plan`` and ``data`` extras), the same phases, and the port's flat
    metrics the JAX keys plus the port's own device keys."""
    mine = ledger.read(_run(tmp_path, "port", "t", runs=1))[0]
    ref = jax_ledger.read(_run(tmp_path, "jax", "j", runs=1))[0]
    assert set(mine) == set(ref)
    assert set(mine["phases_s"]) == set(ref["phases_s"])
    assert set(mine["data"]) == set(ref["data"])
    assert mine["data"]["distinct_out"] == ref["data"]["distinct_out"]
    assert set(mine["plan"]) == set(ref["plan"])
    assert set(mine["metrics"]) - set(ref["metrics"]) <= {
        "accumulator_device", "device"}
    assert mine["metrics"]["records_in"] == ref["metrics"]["records_in"]
    assert mine["corpus_bytes"] == ref["corpus_bytes"]
    assert mine["version"] == ref["version"]


def test_a_cross_package_pair_diffs_alike_when_forced(tmp_path):
    """The same job in each package: different config identities (the
    JAX config has the sharded fields), so the diff refuses unless
    forced, and forced, both packages report the same rows."""
    mine = ledger.read(_run(tmp_path, "port", "t", runs=1))[0]
    ref = jax_ledger.read(_run(tmp_path, "jax", "j", runs=1))[0]
    for mod in (ledger, jax_ledger):
        with pytest.raises(ValueError, match="config_hash"):
            mod.diff_entries(ref, mine)
    forced = ledger.diff_entries(ref, mine, force=True)
    assert forced == jax_ledger.diff_entries(ref, mine, force=True)
    assert any("config_hash" in w for w in forced["warnings"])


@pytest.mark.parametrize("key,value", [
    ("workload", "bigram"), ("config_hash", "other"), ("version", "9"),
    ("corpus_bytes", 1), ("corpus_bytes", None)])
def test_check_comparable_like_jax(key, value):
    a = {"workload": "wc", "config_hash": "h", "version": "1",
         "corpus_bytes": 10}
    b = dict(a, **{key: value})
    assert ledger.check_comparable(a, b, force=True) == \
        jax_ledger.check_comparable(a, b, force=True)
    if value is not None:
        with pytest.raises(ledger.LedgerMismatch):
            ledger.check_comparable(a, b)


def test_entry_from_a_crash_bundle_like_jax(tmp_path):
    """A port flight-recorder bundle's metrics document becomes the same
    ledger-shaped entry in both packages."""
    cfg = JobConfig(input_path=str(tmp_path / "x"), backend="cpu",
                    crash_dir=str(tmp_path / "crash"))
    obs = Obs.from_config(cfg)
    with pytest.raises(RuntimeError):
        with obs.recording(cfg, "wordcount"):
            obs.registry.count("spill/rows", 7)
            raise RuntimeError("injected")
    (bundle,) = (tmp_path / "crash").iterdir()
    doc = json.loads((bundle / "metrics.json").read_text())
    entry = ledger.entry_from_metrics_doc(doc)
    assert entry == jax_ledger.entry_from_metrics_doc(doc)
    assert entry["aborted"] is True
    assert entry["metrics"]["spill/rows"] == 7


def test_the_live_plane_fields_stay_out_of_the_identity():
    base = JobConfig(input_path="a")
    for name in LIVE_FIELDS:
        assert name not in ledger.config_identity(base)
    changed = dataclasses.replace(
        base, input_path="b", ledger_dir="l", obs_port=0, obs_sample_s=1.0,
        obs_spool="none", slo_rules="[]", incident_dir="i",
        profile_dir="p", host_sample_hz=10.0)
    assert ledger.config_hash(changed) == ledger.config_hash(base)
    assert ledger._NON_IDENTITY_FIELDS == jax_ledger._NON_IDENTITY_FIELDS


def test_gate_flags_a_regression_like_jax(tmp_path):
    """``gate_against_previous`` over one ledger holding a slow run after
    a fast one: both packages name the same regressions."""
    base = {"ts_unix_s": 1, "version": "1", "config_hash": "h",
            "workload": "wc", "corpus_bytes": 10, "n_processes": 1,
            "phases_s": {"map+reduce": 1.0},
            "metrics": {"records_per_sec": 1000.0, "heartbeat/stalls": 0}}
    slow = dict(base, ts_unix_s=2, phases_s={"map+reduce": 2.0},
                metrics={"records_per_sec": 400.0, "heartbeat/stalls": 2})
    ldir = str(tmp_path / "l")
    ledger.append(ldir, base)
    jax_ledger.append(ldir, slow)
    got = ledger.gate_against_previous(ldir, slow)
    assert got == jax_ledger.gate_against_previous(ldir, slow)
    assert any("map+reduce" in r for r in got)
    assert any("stall" in r for r in got)
