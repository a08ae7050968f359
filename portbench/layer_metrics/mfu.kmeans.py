"""The whole k-means job's share of the card's float32 peak: the
operations of every ``kmeans_assign_sum`` call the window's jobs needed
(``roofline/kmeans_assign_sum.py``) over the window and the published
peak.  Whatever kernel computes the assignment, this share bounds it."""

from portbench import roofline
from portbench.roofline import kmeans_assign_sum as ka


def read(run):
    calls = sum(int(j["metrics"].get("iters", 0)) for j in run.done)
    if not calls or run.device_name == "cpu":
        return None
    precision = run.config["job_params"]["kmeans_precision"]
    flops, _ = ka.count(run.dataset["n"], run.dataset["d"],
                        int(run.config["job_params"]["kmeans_k"]), precision)
    peak = ka.peak_flops(roofline.peaks(run.device_name), precision)
    return 100.0 * calls * flops / (run.window_s * peak)
