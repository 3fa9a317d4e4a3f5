"""epoch_ms: the window's wall time over the steps it completed (host
clock, the window ending in a device synchronise); one full-batch
Parallel ADMM iteration is one epoch."""


def read(run):
    return 1e3 * run["window_s"] / run["steps"]
