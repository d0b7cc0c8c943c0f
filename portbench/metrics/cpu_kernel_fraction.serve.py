"""cpu_kernel_fraction: the share of conv2's kernels on devices whose
backend is not cuda, from HeteroCluster.shares_for at the window's end
(Eq. 1 with the master's measured duty), in %."""


def read(run):
    share = run.window.get("cpu_kernel_share")
    return None if share is None else 100.0 * share
