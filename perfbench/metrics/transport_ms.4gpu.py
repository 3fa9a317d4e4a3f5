"""transport_ms.4gpu: rank 0's host milliseconds a step inside the
program's process transport (its own clock, ``ProcessTransport.time_s``:
posting the neighbour exchange's rounds, waiting on them, the all-gathers
and the sums over ranks), over the window."""


def read(run):
    if run["chips"] < 2:
        return None
    return 1e3 * run["transport_s"] / run["steps"]
