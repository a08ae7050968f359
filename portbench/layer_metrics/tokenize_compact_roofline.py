"""Share of its roofline that ``tokenize_compact`` reaches: the bytes the
window's chunks need (each input byte read once, each token's row written
once; ``roofline/tokenize_compact.py``) at the published HBM bandwidth,
over the device time of the kernels in its namespace in the trace."""

from portbench import roofline
from portbench.roofline import tokenize_compact as tc


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds("tokenize_compact")
    if seconds <= 0 or not run.done:
        return None
    nbytes = sum(tc.count(run.dataset["bytes"],
                          int(j["metrics"]["records_in"]))[1]
                 for j in run.done)
    peaks = roofline.peaks(run.device_name)
    pct, _ = roofline.share(0, nbytes, seconds, 1.0,
                            peaks["hbm_bytes_per_s"])
    return pct
