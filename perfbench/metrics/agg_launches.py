"""agg_launches: the aggregation kernels' launches per step in the window,
from the program's launch counters (ELL, packed, fused and dense); the
counters count launches on the card only."""


def read(run):
    if not run["on_card"]:
        return None
    return sum(run["launches"].values()) / run["steps"]
