"""The port's ``obs`` CLI (``obs/cli.py``) against the JAX package's, on the
CPU.  The two ``build_obs_parser``s agree on every subcommand, flag,
default and ``dest``; on the same metrics documents, run ledgers,
calibration stores, crash bundles, capture bundles and ``BENCH_r*.json``
rounds both CLIs print the same stdout bytes and return the same exit
code, over documents written by a JAX job and by a port job of the same
config; ``merge`` and ``critpath`` over a port multi-process job's trace
shards print what the JAX CLI prints; and a subprocess running every
offline subcommand imports neither ``jax`` nor ``torch``.
"""

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from map_oxidize_tpu import api as jax_api
from map_oxidize_tpu.cli import main as jax_main
from map_oxidize_tpu.config import JobConfig as JaxJobConfig
from map_oxidize_tpu.obs import calib as jax_calib
from map_oxidize_tpu.obs import profiler as jax_profiler
from map_oxidize_tpu.obs.cli import build_obs_parser as jax_parser
from map_oxidize_tpu.runtime import run_job as jax_run_job
from map_oxidize_tpu.runtime.driver import (
    run_wordcount_job as jax_run_wordcount_job,
)
from map_oxidize_tpu.workloads import wordcount as jax_wordcount
from map_oxidize_tpu_torch import api as port_api
from map_oxidize_tpu_torch.cli import main as port_main
from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.obs import profiler as port_profiler
from map_oxidize_tpu_torch.obs.cli import build_obs_parser
from map_oxidize_tpu_torch.runtime import run_job
from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
from map_oxidize_tpu_torch.workloads import wordcount as port_wordcount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KM = dict(kmeans_k=4, kmeans_iters=3, kmeans_precision="highest")
KM_RUNS = 3
WC_RUNS = 2
IDENT = {"platform": "cpu", "device_count": 8, "topology": "1x8"}
PACKAGES = ("jax", "port")


# --- the documents ------------------------------------------------------------


def _corpus(path, seed=5, lines=600):
    rng = np.random.default_rng(seed)
    words = [f"w{i}".encode() for i in range(80)]
    with open(path, "wb") as f:
        for _ in range(lines):
            f.write(b" ".join(words[int(i)]
                              for i in rng.integers(0, 80, 10)) + b"\n")
    return str(path)


def _points(path, seed=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(4, 4))
    pts = centers[rng.integers(0, 4, 3000)] + rng.normal(size=(3000, 4))
    np.save(path, pts.astype(np.float32))
    return str(path)


def _failing_mapper(pkg):
    """The Python word-count map of ``pkg`` that raises in chunk 2."""
    api, wc = ((port_api, port_wordcount) if pkg == "port"
               else (jax_api, jax_wordcount))

    class Failing(api.Mapper):
        def __init__(self):
            self.inner, _ = wc.make_wordcount("ascii", use_native=False)
            self.value_shape = self.inner.value_shape
            self.value_dtype = self.inner.value_dtype
            self.keys_have_dictionary = True
            self.calls = 0

        def map_chunk(self, chunk):
            self.calls += 1
            if self.calls == 2:
                raise ValueError("mapper failed in chunk 2")
            return self.inner.map_chunk(chunk)

    return Failing(), wc.make_wordcount("ascii", use_native=False)[1]


def _write_documents(root, pkg):
    """Every artifact one package's jobs write: three k-means runs into one
    ledger and calibration store, two word counts into a second ledger, a
    crash bundle, and a host-only capture bundle."""
    os.makedirs(root)
    cfg_cls, run = ((JobConfig, run_job) if pkg == "port"
                    else (JaxJobConfig, jax_run_job))
    extra = {"backend": "cpu"} if pkg == "port" else {"num_shards": 1}
    pts = _points(os.path.join(root, "pts.npy"))
    corpus = _corpus(os.path.join(root, "c.txt"))
    for i in range(KM_RUNS):
        run(cfg_cls(input_path=pts, metrics=False,
                    output_path=os.path.join(root, f"cent{i}.npy"),
                    ledger_dir=os.path.join(root, "ledger_km"),
                    calib_dir=os.path.join(root, "calib"),
                    metrics_out=os.path.join(root, f"km{i}.json"),
                    **extra, **KM), "kmeans")
    for i in range(WC_RUNS):
        run(cfg_cls(input_path=corpus, metrics=False, num_chunks=3,
                    output_path=os.path.join(root, f"wc{i}.txt"),
                    ledger_dir=os.path.join(root, "ledger_wc"),
                    metrics_out=os.path.join(root, f"wc{i}.json"),
                    **extra), "wordcount")
    mapper, reducer = _failing_mapper(pkg)
    run_wc = run_wordcount_job if pkg == "port" else jax_run_wordcount_job
    with pytest.raises(Exception, match="mapper failed in chunk 2"):
        run_wc(cfg_cls(input_path=corpus, metrics=False, num_chunks=3,
                       output_path="", num_map_workers=1, max_retries=0,
                       crash_dir=os.path.join(root, "crash"), **extra),
               mapper, reducer)
    prof = port_profiler if pkg == "port" else jax_profiler
    prof.capture(os.path.join(root, "profiles"), duration_s=0.3,
                 host_sample_hz=200.0, device=False)
    # a copy of the k-means ledger with the last run's iterate phase a
    # second slower (past the diff's 50 ms floor on phase noise): a
    # regression ``obs diff --gate`` must flag
    slow = os.path.join(root, "ledger_slow")
    shutil.copytree(os.path.join(root, "ledger_km"), slow)
    path = os.path.join(slow, "ledger.jsonl")
    with open(path) as f:
        entries = [json.loads(line) for line in f if line.strip()]
    entries[-1]["phases_s"]["iterate"] += 1.0
    entries[-1]["metrics"]["time/iterate_s"] += 1.0
    with open(path, "w") as f:
        f.write("".join(json.dumps(e) + "\n" for e in entries))
    return root


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_cli")
    out = {pkg: _write_documents(str(root / pkg), pkg) for pkg in PACKAGES}
    # a JAX-written calibration store with comms rows (the port writes
    # none until A7): the rows the exchange chooser's cells look up
    store = jax_calib.CalibStore(path=str(root / "comms" / "calib.json"))
    rows = []
    for coll in jax_calib.EXCHANGE_COLLECTIVE_NAMES:
        for k in range(12):
            rows.append({"collective": coll, "program": "shuffle/merge",
                         "count": 4, "bytes": float(4 << (10 + 2 * k)),
                         "latency_ms": {"count": 4, "mean": 0.5 + k},
                         "shape": [k]})
    store.accumulate_run(IDENT, rows, {"programs": {}})
    store.save_merged()
    out["comms"] = str(root / "comms")
    return out


def _run(main, argv):
    """``main(["obs", *argv])`` with stdout and stderr captured."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["obs", *argv])
    return rc, out.getvalue(), err.getvalue()


def _same(argv, rc=0):
    """Both CLIs on ``argv``: equal exit codes (``rc``) and stdout bytes."""
    got = _run(port_main, argv)
    ref = _run(jax_main, argv)
    assert (got[0], ref[0]) == (rc, rc), (got[2], ref[2])
    assert got[1] == ref[1]
    return got[1]


# --- the parser ---------------------------------------------------------------


def _actions(parser: argparse.ArgumentParser, prefix="") -> dict:
    """``{(subcommand path, dest): spec}`` of every argument, recursing
    into subparsers."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out[(prefix, a.dest)] = ("subcommands", sorted(a.choices),
                                     a.required)
            for name, sub in a.choices.items():
                out.update(_actions(sub, f"{prefix} {name}".strip()))
            continue
        out[(prefix, a.dest)] = (tuple(a.option_strings), type(a).__name__,
                                 a.default, a.nargs, a.required,
                                 getattr(a.type, "__name__", a.type),
                                 a.metavar)
    return out


def test_obs_parsers_agree_on_every_flag_default_and_dest():
    mine, ref = _actions(build_obs_parser()), _actions(jax_parser())
    assert mine == ref
    subs = {k[0] for k in ref}
    assert {"merge", "critpath", "diff", "xprof", "data", "trend", "where",
            "plan", "flame", "calib", "fleet", "top", "calib show",
            "calib probe", "calib coverage"} <= subs


# --- the reports, byte for byte -------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("sub,doc,flags", [
    ("xprof", "km0.json", ()),
    ("xprof", "km2.json", ("--json",)),
    ("xprof", "wc0.json", ()),
    ("data", "wc0.json", ()),
    ("data", "wc1.json", ("--json",)),
    ("plan", "km1.json", ()),
    ("plan", "wc0.json", ("--json",)),
    ("where", "km0.json", ()),
    ("where", "wc0.json", ("--json",)),
    ("critpath", "km0.json", ()),
    ("critpath", "wc1.json", ("--json",)),
])
def test_document_reports_print_the_jax_bytes(docs, pkg, sub, doc, flags):
    out = _same([sub, os.path.join(docs[pkg], doc), *flags])
    assert out.strip()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("sub", ["xprof", "where", "critpath"])
def test_crash_bundle_reports_print_the_jax_bytes(docs, pkg, sub):
    """A ``--crash-dir`` root resolves to its newest bundle in both."""
    crash = os.path.join(docs[pkg], "crash")
    (bundle,) = glob.glob(os.path.join(crash, "crash_*"))
    out = _same([sub, crash])
    assert out == _same([sub, bundle])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_missing_sections_fail_alike(docs, pkg):
    """A k-means document has no data-audit section, and a crash bundle
    of a job killed in its map neither that nor a plan: both exit 2."""
    _same(["data", os.path.join(docs[pkg], "km0.json")], rc=2)
    _same(["data", os.path.join(docs[pkg], "crash")], rc=2)
    _same(["plan", os.path.join(docs[pkg], "crash")], rc=2)
    _same(["xprof", os.path.join(docs[pkg], "nope.json")], rc=2)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_calib_show_and_the_legacy_form(docs, pkg):
    store = os.path.join(docs[pkg], "calib")
    out = _same(["calib", "show", store])
    assert "kmeans/fit" in out or "programs" in out
    assert _same(["calib", store]) == out
    assert json.loads(_same(["calib", store, "--json"]))["runs"] == KM_RUNS
    _same(["calib", "show", os.path.join(docs[pkg], "nowhere")], rc=2)


@pytest.mark.parametrize("flags", [(), ("--collect",), ("--json",),
                                   ("--num-shards", "4", "--batch-size",
                                    "4096")])
def test_calib_coverage_on_a_jax_store_with_comms_rows(docs, flags):
    out = _same(["calib", "coverage", docs["comms"], *flags])
    assert "all_to_all" in out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_diff_plain_gate_and_crash_dir(docs, pkg):
    root = docs[pkg]
    km = os.path.join(root, "ledger_km")
    out = _same(["diff", "--ledger-dir", km])
    assert "iterate" in out
    # the attribution-coverage gates count points, past any percent
    _same(["diff", "--ledger-dir", km, "0", "2", "--threshold-pct", "1e9"])
    slow = os.path.join(root, "ledger_slow")
    gated = _same(["diff", "--ledger-dir", slow, "--threshold-pct", "50",
                   "--gate"], rc=3)
    assert "iterate" in gated
    out = _same(["diff", "--ledger-dir", os.path.join(root, "ledger_wc"),
                 "--crash-dir", os.path.join(root, "crash"), "--force"])
    assert out.startswith("NOTE: comparing against a crash bundle")
    # the killed run used the Python map: another config identity
    _same(["diff", "--ledger-dir", os.path.join(root, "ledger_wc"),
           "--crash-dir", os.path.join(root, "crash")], rc=2)
    _same(["diff", "--ledger-dir", os.path.join(root, "empty")], rc=2)
    _same(["diff", "--ledger-dir", km, "0"], rc=2)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_trend_over_the_ledgers(docs, pkg):
    root = docs[pkg]
    out = _same(["trend", "--ledger-dir", os.path.join(root, "ledger_km")])
    assert out.startswith(f"trend: kmeans — {KM_RUNS} entries")
    doc = json.loads(_same(["trend", "--ledger-dir",
                            os.path.join(root, "ledger_km"), "--json"]))
    assert doc["n_entries"] == KM_RUNS
    _same(["trend", "--ledger-dir", os.path.join(root, "ledger_slow"),
           "--all-series", "--top", "0"])
    _same(["trend", "--ledger-dir", os.path.join(root, "ledger_wc"),
           "--last", "2", "--threshold-pct", "5"])


def test_trend_over_the_repo_s_bench_rounds():
    """The repo's own rounds.  BENCH_r01 and r03 hold ``"parsed": null``
    (runs that printed no result): the JAX ``bench_rounds`` raises
    AttributeError on them, the port's reads them as points with no
    values.  The other three rounds print the same bytes in both."""
    rounds = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in (2, 4, 5)]
    out = _same(["trend", "--bench", *rounds])
    assert out.startswith("trend: bench-rounds — 3 entries")
    _same(["trend", "--bench", *rounds, "--json"])
    multi = os.path.join(REPO, "MULTICHIP_r0*.json")
    _same(["trend", "--bench", multi])
    _same(["trend", "--bench", *rounds, multi, "--top", "3"])
    _same(["trend"], rc=2)
    every = os.path.join(REPO, "BENCH_r0*.json")
    with pytest.raises(AttributeError):
        _run(jax_main, ["trend", "--bench", every])
    rc, out, _ = _run(port_main, ["trend", "--bench", every])
    assert rc == 0 and out.startswith("trend: bench-rounds — 5 entries")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_flame_over_a_capture_bundle(docs, pkg):
    root = os.path.join(docs[pkg], "profiles")
    (bundle,) = glob.glob(os.path.join(root, "profile_*"))
    out = _same(["flame", root])
    assert out.startswith("host sampling profile:")
    assert _same(["flame", bundle, "--top", "3"])
    _same(["flame", os.path.join(bundle, "host_stacks.collapsed")])
    _same(["flame", os.path.join(root, "nope")], rc=2)


# --- the multi-process parts: real trace shards ------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A port 2-process word count's ``t.json.proc<i>`` trace shards and
    their merged trace (``merged.json``)."""
    import test_torch_distributed as td
    from map_oxidize_tpu_torch.obs.merge import find_shards, merge_to_files

    tmp = tmp_path_factory.mktemp("obs_cli_shards")
    corpus = td.write_corpus(tmp / "c.txt", lines=1500)
    td.launch(tmp, "wordcount", dict(
        input_path=corpus, output_path="", chunk_bytes=4096,
        batch_size=1 << 12, key_capacity=1 << 12, num_shards=8,
        trace_out=str(tmp / "t.json")))
    merge_to_files(find_shards(str(tmp / "t.json")),
                   str(tmp / "merged.json"))
    return tmp


@pytest.mark.parametrize("argv", [
    ["merge", "TRACE"],
    ["critpath", "TRACE"],
    ["critpath", "TRACE.proc0"],
    ["critpath", "MERGED"],
])
def test_multi_process_parts_exit_2_naming_their_item(shards, argv):
    """``obs merge`` and ``obs critpath`` over a port multi-process job's
    shards, one shard, and the merged trace: both CLIs print the same
    bytes and exit 0."""
    trace = shards / "t.json"
    paths = {"TRACE": str(trace), "TRACE.proc0": str(trace) + ".proc0",
             "MERGED": str(shards / "merged.json")}
    out = _same([paths.get(a, a) for a in argv])
    assert out
    if argv[0] == "merge":
        assert out.startswith(f"merged 2 shards -> {trace}")
    else:
        assert "bound by:" in out
    _same([paths.get(a, a) for a in argv] + (
        ["--json"] if argv[0] == "critpath" else []))


def test_calib_probe_round_trip_fills_a_selectable_curve(tmp_path):
    """``obs calib probe`` sweeps both exchange wire programs, the psum
    and the top-k gather on an 8-slot CPU mesh, merges the rows with
    ``source=probe``, and one probe is evidence enough for the chooser
    (JAX ``tests/test_calib_probe.py:290``); the report and the JSON
    summary have the JAX package's shape."""
    from map_oxidize_tpu.obs.probe import render_probe as jax_render
    from map_oxidize_tpu_torch.obs import calib
    from map_oxidize_tpu_torch.obs.probe import render_probe
    from map_oxidize_tpu_torch.runtime.planner import choose_collective

    store_dir = tmp_path / "calib"
    rc, out, err = _run(port_main, ["calib", "probe", str(store_dir),
                                    "--num-shards", "8", "--backend", "cpu",
                                    "--buckets", "16KB", "32KB", "--reps",
                                    "3", "--json"])
    assert rc == 0, err
    summary = json.loads(out)
    assert summary["schema"] == "moxt-calib-probe-v1"
    assert summary["num_shards"] == 8 and summary["rows_merged"] > 0
    assert summary["identity"]["platform"] == "cpu"
    progs = {(c["collective"], c["program"]) for c in summary["cells"]}
    assert progs == {("all_to_all", "shuffle/merge"),
                     ("all_gather", "shuffle/merge"),
                     ("psum", "shuffle/merge"),
                     ("all_gather", "shuffle/top_k")}
    assert render_probe(summary) == jax_render(summary)
    rc, text, _ = _run(port_main, ["calib", "probe", str(tmp_path / "c2"),
                                   "--num-shards", "8", "--backend", "cpu",
                                   "--buckets", "16KB", "--reps", "3"])
    assert rc == 0 and text.startswith("calibration probe: ")
    assert text.splitlines()[1] == jax_render(summary).splitlines()[1]
    store = calib.CalibStore.load(str(store_dir))
    assert store.doc["runs"] == 1
    assert all(r["source"] == "probe" for r in store.doc["comms"].values())
    ident = summary["identity"]
    cell = next(c for c in summary["cells"]
                if c["program"] == "shuffle/merge")
    cap = cell["payload_bytes"] // (8 * 8 * (8 + 4))
    d = choose_collective(store, ident, 8, cap, 4)
    assert d["provenance"] == "curve", d["reason"]
    assert d["evidence"][d["method"]]["by_source"].get("probe", 0) >= 3
    rep = calib.coverage_report(
        store, ident, [{"collective": c, "bucket": d["bucket"]}
                       for c in ("all_to_all", "all_gather")])
    assert rep["coverage_pct"] == 100.0


# --- no jax, no torch ---------------------------------------------------------------


def test_offline_subcommands_import_neither_jax_nor_torch(docs):
    """Every offline subcommand in one fresh process: neither ``jax`` nor
    ``torch`` is imported, so nothing initialises CUDA."""
    root = docs["port"]
    runs = [
        ["xprof", f"{root}/km0.json"], ["data", f"{root}/wc0.json"],
        ["plan", f"{root}/km0.json"], ["where", f"{root}/km0.json"],
        ["critpath", f"{root}/crash"], ["calib", f"{root}/calib"],
        ["calib", "coverage", docs["comms"]],
        ["diff", "--ledger-dir", f"{root}/ledger_km"],
        ["trend", "--ledger-dir", f"{root}/ledger_km", "--json"],
        ["flame", f"{root}/profiles"], ["merge", "x"],
        ["top", "--archive", f"{root}/none"],
    ]
    script = (
        "import contextlib, io, json, sys\n"
        "from map_oxidize_tpu_torch.cli import main\n"
        f"rcs = []\n"
        f"for argv in {runs!r}:\n"
        "    with contextlib.redirect_stdout(io.StringIO()), \\\n"
        "            contextlib.redirect_stderr(io.StringIO()):\n"
        "        rcs.append(main(['obs', *argv]))\n"
        "print(json.dumps({'rcs': rcs, 'jax': 'jax' in sys.modules,\n"
        "                  'torch': 'torch' in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"rcs": [0] * 10 + [2, 2], "jax": False, "torch": False}
