"""Share of its roofline that ``kmeans_assign_sum`` reaches: the least time
the card could take for the window's calls (operations and bytes from
``roofline/kmeans_assign_sum.py``, against the published peaks) over the
device time of the kernels in its namespace in the trace.  One call per
iteration of each job."""

from portbench import roofline
from portbench.roofline import kmeans_assign_sum as ka


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds("kmeans_assign_sum")
    calls = sum(int(j["metrics"].get("iters", 0)) for j in run.done)
    if seconds <= 0 or not calls:
        return None
    precision = run.config["job_params"]["kmeans_precision"]
    flops, nbytes = ka.count(run.dataset["n"], run.dataset["d"],
                             int(run.config["job_params"]["kmeans_k"]),
                             precision)
    peaks = roofline.peaks(run.device_name)
    pct, _ = roofline.share(calls * flops, calls * nbytes, seconds,
                            ka.peak_flops(peaks, precision),
                            peaks["hbm_bytes_per_s"])
    return pct
