"""Milliseconds per job of the write phase (the sort and formatting of
every distinct word's row, and the file's atomic replace): each job's
``time/write_s``, the median over the window's jobs."""

from portbench.counters import median


def read(run):
    s = median(run, "time/write_s")
    return None if s is None else 1e3 * s
