"""Where the tokenize kernel's time goes: build variants of
``map_oxidize_tpu_torch/ops/csrc/tokenize_compact.cu`` with one part of
the work taken out after another, and time each at ``chip_smoke.py``
phase 3's chunk (the first 32 MiB of phase 5's corpus).

The variants whose name starts with ``no`` compute a wrong result on
purpose: the time they save is the time of the part they leave out.  The
others change the block size and must stay bit-equal to
``tokenize_compact_plain``.  Each variant is built with the port's nvcc
flags, all builds started together, into ``map_oxidize_tpu_torch/_build/
probe/``.  Needs one CUDA card:

    python3 scripts/tokenize_probe.py

Prints the card's name and power limit, a line per variant and round, and
one JSON object as the last line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the edits that make each variant: (anchor in the source, replacement);
#: each anchor must occur in the source
NO_FILL = [("  fill_rows(t_hi, t_lo, t_start, p.lo, p.hi, tid, nth);\n"
            "  fill_rows(t_hi, t_lo, t_start, p.slice_lo, p.slice_hi, tid, "
            "nth);\n", "")]
NO_STORE = [("    const int count = (int)min((long long)tile_ends, "
             "max_tokens - row0);", "    const int count = 0;")]
NO_LOOK_BACK = [("      excl = look_back(t, agg, pre);", "")]


def threads(n: int, min_blocks: int) -> list[tuple[str, str]]:
    return [("constexpr int THREADS = 256;", f"constexpr int THREADS = {n};"),
            ("__launch_bounds__(THREADS, 4)",
             f"__launch_bounds__(THREADS, {min_blocks})")]


VARIANTS = {
    "kernel": [],
    "no padding fill": NO_FILL,
    "no padding fill, no row stores": NO_FILL + NO_STORE,
    "no padding fill, no row stores, no look-back":
        NO_FILL + NO_STORE + NO_LOOK_BACK,
    "128 threads per block": threads(128, 8),
    "512 threads per block": threads(512, 2),
}
ROUNDS, CALLS = 2, 50


def variant_source(src: str, edits: list[tuple[str, str]]) -> str:
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def build_all(out_dir: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Every variant's library and its ``-Xptxas -v`` resource line."""
    from map_oxidize_tpu_torch.ops import build
    from map_oxidize_tpu_torch.ops.device_tokenize import bind_library

    src = (build.CSRC / "tokenize_compact.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(src, edits))
        so = out_dir / f"libvariant{i}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        usage = "; ".join(line.split(":", 1)[-1].strip()
                          for line in log.splitlines()
                          if "Used" in line or "spill" in line)
        libs[name] = (bind_library(ctypes.CDLL(str(so))), usage)
    return libs


def time_variant(lib: ctypes.CDLL, chunk, max_tokens: int, want):
    """ms per call over CALLS back-to-back calls (CUDA events) into
    preallocated outputs, and whether the first call's outputs equal
    ``want`` (they start as a pattern no row holds)."""
    import torch

    n = chunk.shape[0]
    scratch = torch.empty(lib.moxt_tokenize_compact_scratch(n),
                          dtype=torch.uint8, device=chunk.device)
    outs = [torch.full((max_tokens,), 0x5A5A5A5A, dtype=torch.int32,
                       device=chunk.device) for _ in range(3)]
    outs.append(torch.full((), -1, dtype=torch.int32, device=chunk.device))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.moxt_tokenize_compact(
            chunk.device.index or 0, chunk.data_ptr(), n, max_tokens,
            scratch.data_ptr(), *(o.data_ptr() for o in outs), stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    equal = all(torch.equal(o, w) for o, w in zip(outs, want))
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS, equal


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tokenize_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from map_oxidize_tpu_torch.io.splitter import iter_chunks_capped
    from map_oxidize_tpu_torch.ops.device_tokenize import (
        pad_chunk,
        tokenize_compact_plain,
    )

    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_all(ROOT / "map_oxidize_tpu_torch" / "_build" / "probe")
    n = chip_smoke.CHUNK_BYTES
    with tempfile.TemporaryDirectory(prefix="moxt_probe_") as tmp:
        path = chip_smoke.write_corpus(tmp, chip_smoke.CORPUS_BYTES,
                                       chip_smoke.VOCAB)
        arr = pad_chunk(bytes(next(iter_chunks_capped(path, n))), n).copy()
    chunk = torch.from_numpy(arr).cuda()
    max_tokens = n // 2 + 1
    want = tokenize_compact_plain(chunk, max_tokens)
    torch.cuda.synchronize()
    result = {name: {"ms": [], "usage": usage, "bit_equal": None}
              for name, (_, usage) in libs.items()}
    for rnd in range(ROUNDS):
        for name, (lib, usage) in libs.items():
            ms, equal = time_variant(lib, chunk, max_tokens, want)
            result[name]["ms"].append(ms)
            result[name]["bit_equal"] = equal
            print(f"round {rnd}: {name}: {ms:.4f} ms, bit-equal {equal}; "
                  f"{usage}", flush=True)
    print(json.dumps({"card": card, "n": n, "max_tokens": max_tokens,
                      "tokens": int(want[3]), "calls": CALLS,
                      "variants": result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
