"""State carried across between the JAX package and the port.

This system's "weights" are its reduce state.  The JAX fold engine's
``export_state()`` is a dict of numpy arrays — uint32 key planes
``acc_hi``/``acc_lo``, ``acc_vals``, the dropped-key count ``ovf``,
``n_unique`` (-1 before any merge) and the host counters ``n_live_ub`` and
``rows_fed``.  The port's engine holds the same state as device tensors
with int64 order keys (``acc_keys``).  k-means state needs no converter:
centroids cross as a plain float32 ``(k, d)`` array.
"""

from __future__ import annotations

import numpy as np
import torch

from map_oxidize_tpu_torch.ops.segment_reduce import (
    keys_from_planes,
    planes_from_keys,
)


def engine_state_from_jax(st: dict, device) -> dict:
    """JAX ``DeviceReduceEngine.export_state()`` -> the port's
    ``DeviceReduceEngine.import_state`` dict, with tensors on ``device``."""
    device = torch.device(device)
    keys = keys_from_planes(st["acc_hi"], st["acc_lo"])
    return {
        "acc_keys": torch.from_numpy(keys).to(device),
        "acc_vals": torch.from_numpy(np.array(st["acc_vals"])).to(device),
        "ovf": torch.tensor(int(st["ovf"]), dtype=torch.int64, device=device),
        "n_unique": int(st["n_unique"]),
        "n_live_ub": int(st["n_live_ub"]),
        "rows_fed": int(st["rows_fed"]),
    }


def engine_state_to_numpy(st: dict) -> dict:
    """The port's ``export_state()`` -> the JAX engine's dict, with the same
    key names and dtypes (so its ``import_state`` takes it)."""
    hi, lo = planes_from_keys(st["acc_keys"])
    return {
        "acc_hi": hi,
        "acc_lo": lo,
        "acc_vals": st["acc_vals"].cpu().numpy(),
        "ovf": np.asarray(int(st["ovf"]), np.int32),
        "n_unique": np.asarray(int(st["n_unique"]), np.int32),
        "n_live_ub": np.int64(st["n_live_ub"]),
        "rows_fed": np.int64(st["rows_fed"]),
    }
