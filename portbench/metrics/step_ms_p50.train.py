"""The median training step of the window in ms, each from its start to
its synchronized end, host clock."""

import statistics


def read(run):
    return statistics.median(run.call_s) * 1e3
