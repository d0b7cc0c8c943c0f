"""setup_s: from the process's start to the window's start (loading,
building or loading the kernels, the Eq. 1 probe, the weights, the
warm-up and the checked first steps)."""


def read(run):
    return run.setup_s
