"""Seconds per k-means job: the window over the jobs completed in it."""


def read(run):
    return run.window_s / len(run.done) if run.done else None
