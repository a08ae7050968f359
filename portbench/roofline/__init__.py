"""Roofline arithmetic: each kernel's operations and bytes from its shapes
(one module per kernel, named after the kernel), the published peaks
(``peaks.json``), and the share of the bound that a measured time reaches."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """The published peaks of the card whose name ``torch.cuda.
    get_device_name()`` gives; raises for a card the table lacks."""
    table = json.loads(PEAKS.read_text())
    for prefix, row in table.items():
        if device_name.startswith(prefix):
            return row
    raise KeyError(f"no published peaks for {device_name!r}")


def share(flops: float, nbytes: float, seconds: float, flops_per_s: float,
          bytes_per_s: float) -> tuple[float, str]:
    """``(percent, bound)``: the least time the chip could take for the
    work, the larger of operations over peak operations and bytes over
    peak bandwidth, as a percentage of ``seconds``; ``bound`` names the
    larger ('operations' or 'bytes')."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / bytes_per_s
    bound = "operations" if t_ops >= t_bytes else "bytes"
    return 100.0 * max(t_ops, t_bytes) / seconds, bound
