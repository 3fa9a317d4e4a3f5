"""idle_share.4gpu: as idle_share, on rank 0's card: the share of the
traced window in which nothing ran on it."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
