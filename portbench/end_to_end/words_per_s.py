"""Words per second: every word the window's completed jobs counted (their
``records_in``) over the window."""


def read(run):
    if not run.done:
        return None
    return sum(int(j["metrics"]["records_in"]) for j in run.done) / run.window_s
