"""Device milliseconds per ``kmeans_assign_sum`` launch: the device time of
the kernels in its namespace in the trace over the launches the window's
jobs counted (each job's ``kmeans/assign_sum_calls``), so that a route
that fuses, splits or streams its launches is read right.  None where a
job lacks the counter (a port that does not count them)."""


def read(run):
    if run.trace is None or not run.done:
        return None
    calls = [j["metrics"].get("kmeans/assign_sum_calls") for j in run.done]
    if any(c is None for c in calls) or not sum(calls):
        return None
    seconds = run.trace.kernel_seconds("kmeans_assign_sum")
    if seconds <= 0:
        return None
    return 1e3 * seconds / sum(calls)
