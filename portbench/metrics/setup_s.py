"""Set-up: from the process's start to the first timed call (loading,
making the weights, building the state, warming up every shape, and in a
checkout's first run building the kernels), host clock."""


def read(run):
    return run.setup_s
