"""The config identity hash of a job: a copy of ``config_identity`` and
``config_hash`` from the JAX package's ``obs/ledger.py`` (:65, :72).

``Obs.stamp`` and the flight recorder put the hash in every document they
write, so two documents of the same job compare even when their artifact
paths differ.  The hash covers the fields that change what the engines
compute or how (batch sizes, capacities, tokenizer, precision...) and
leaves out I/O plumbing (paths, observability flags).  The run ledger
itself (``--ledger-dir``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

#: config fields that do NOT change what a run computes or how fast:
#: artifact paths and observability plumbing
_NON_IDENTITY_FIELDS = frozenset({
    "input_path", "output_path", "checkpoint_dir", "keep_intermediates",
    "trace_dir", "trace_out", "metrics_out", "metrics", "progress",
    "progress_interval_s", "crash_dir", "data_audit", "hbm_sample_s",
    "stall_warn_factor", "calib_dir", "calib_min_samples",
})


def config_identity(config) -> dict:
    """The identity-relevant config fields, as a JSON-stable dict."""
    d = dataclasses.asdict(config)
    return {k: v for k, v in sorted(d.items())
            if k not in _NON_IDENTITY_FIELDS}


def config_hash(config) -> str:
    """16-hex digest of the identity-relevant config fields."""
    blob = json.dumps(config_identity(config), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
