"""epoch_ms.4gpu: as epoch_ms, on rank 0 between barriers: all ranks step
together, so this is the slowest rank's pace."""


def read(run):
    return 1e3 * run["window_s"] / run["steps"]
