"""idle_share: the share of the traced window in which nothing ran on the
card (one minus the union of the device intervals over the window)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
