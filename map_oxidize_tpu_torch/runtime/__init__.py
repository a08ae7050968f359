"""Runtime: the device engine and the job drivers.

``run_job`` is the one-call entry point: it resolves where the map phase
runs and dispatches to the matching driver.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.config import JobConfig
from map_oxidize_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


def resolve_mapper(config: JobConfig, workload: str) -> str:
    """'auto' -> 'native', the C++ host loop, as in the JAX package
    (``runtime/__init__.py:16-34``).  ``mapper='device'`` runs the device
    mapper for wordcount and bigram with the ascii tokenizer; every other
    ``mapper='device'`` resolves to 'native' with the JAX package's log
    line.  The device mapper stays opt-in: the JAX package's reason (a
    measured TPU link) is not this card's, and the port measures its own
    (``chip_smoke.py`` phase 11).  A failed native build raises (pass
    'python' for the Python map)."""
    mode = config.mapper
    if mode == "auto":
        mode = "native"
    if mode == "device" and workload not in ("wordcount", "bigram"):
        _log.info("device mapper does not implement %r yet; using native",
                  workload)
        mode = "native"
    if mode == "device" and config.tokenizer != "ascii":
        _log.info("device mapper is ascii-only; using native for %r",
                  config.tokenizer)
        mode = "native"
    return mode


def run_job(config: JobConfig, workload: str = "wordcount", on_obs=None):
    """Run a built-in workload end to end: 'wordcount', 'bigram',
    'invertedindex', 'distinct', 'kmeans', 'sort', 'join' or
    'sessionize'.

    With ``config.trace_dir`` set, the whole job runs under a
    ``torch.profiler`` trace written there (JAX ``runtime/__init__.py:38``,
    there a ``jax.profiler`` trace), counted in ``profile/captures``.
    ``on_obs`` receives the job's ``Obs`` bundle before the body starts."""
    from map_oxidize_tpu_torch.obs.profiler import device_trace

    if config.trace_dir:
        def _on_obs(obs, _orig=on_obs):
            obs.registry.count("profile/captures")
            if _orig is not None:
                _orig(obs)

        with device_trace(config.trace_dir, cuda=config.backend == "cuda"):
            return _run_job(config, workload, _on_obs)
    return _run_job(config, workload, on_obs)


def _run_job(config: JobConfig, workload: str, on_obs=None):
    if workload == "kmeans":
        from map_oxidize_tpu_torch.runtime.driver import run_kmeans_job

        return run_kmeans_job(config, on_obs=on_obs)
    if workload == "invertedindex":
        from map_oxidize_tpu_torch.runtime.driver import (
            run_inverted_index_job,
        )

        return run_inverted_index_job(config, on_obs=on_obs)
    if workload == "distinct":
        from map_oxidize_tpu_torch.runtime.driver import run_distinct_job

        return run_distinct_job(config, on_obs=on_obs)
    if workload in ("sort", "join", "sessionize"):
        from map_oxidize_tpu_torch.runtime.dataflow import (
            run_join_job,
            run_sessionize_job,
            run_sort_job,
        )

        runner = {"sort": run_sort_job, "join": run_join_job,
                  "sessionize": run_sessionize_job}[workload]
        return runner(config, on_obs=on_obs)
    if workload not in ("wordcount", "bigram"):
        raise ValueError(f"unknown workload {workload!r}")
    mode = resolve_mapper(config, workload)
    if mode == "device":
        from map_oxidize_tpu_torch.runtime.device_map import (
            run_device_wordcount_job,
            run_sharded_device_job,
        )
        from map_oxidize_tpu_torch.runtime.driver import effective_num_shards

        ngram = 2 if workload == "bigram" else 1
        if effective_num_shards(config) > 1:
            return run_sharded_device_job(config, ngram, on_obs=on_obs)
        return run_device_wordcount_job(config, ngram, on_obs=on_obs)
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job

    use_native = mode == "native"
    if workload == "wordcount":
        from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

        mapper, reducer = make_wordcount(config.tokenizer, use_native)
    else:
        from map_oxidize_tpu_torch.workloads.bigram import make_bigram

        mapper, reducer = make_bigram(config.tokenizer, use_native)
    return run_wordcount_job(config, mapper, reducer, workload=workload,
                             on_obs=on_obs)
