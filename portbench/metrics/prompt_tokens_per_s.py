"""The prompt tokens of every batch completed in the window over the window's time, from
the first call's start to the last call's synchronized end, host clock."""


def read(run):
    return run.tokens / run.window_s
