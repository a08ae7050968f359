"""Runtime: the device engine and the job drivers.

``run_job`` is the one-call entry point: it resolves where the map phase
runs and dispatches to the matching driver.
"""

from __future__ import annotations

from map_oxidize_tpu_torch.config import JobConfig


def resolve_mapper(config: JobConfig, workload: str) -> str:
    """'auto' -> 'python', the only map path this slice of the port has.
    The native C++ host mapper and the device tokenizer are not ported yet:
    asking for either raises rather than silently running another path."""
    mode = config.mapper
    if mode == "auto":
        return "python"
    if mode == "native":
        raise NotImplementedError(
            "the native C++ host mapper is not ported yet (ROADMAP: native "
            "host mapper); use mapper='auto' or 'python'")
    if mode == "device":
        raise NotImplementedError(
            "the device mapper is not ported yet (ROADMAP: device mapper); "
            "use mapper='auto' or 'python'")
    return mode


def run_job(config: JobConfig, workload: str = "wordcount"):
    """Run a built-in workload end to end: 'wordcount' or 'kmeans'."""
    if workload == "kmeans":
        from map_oxidize_tpu_torch.runtime.driver import run_kmeans_job

        return run_kmeans_job(config)
    if workload != "wordcount":
        raise NotImplementedError(
            f"workload {workload!r} is not ported yet (ROADMAP queue A)")
    from map_oxidize_tpu_torch.runtime.driver import run_wordcount_job
    from map_oxidize_tpu_torch.workloads.wordcount import make_wordcount

    resolve_mapper(config, workload)
    mapper, reducer = make_wordcount(config.tokenizer)
    return run_wordcount_job(config, mapper, reducer, workload=workload)
