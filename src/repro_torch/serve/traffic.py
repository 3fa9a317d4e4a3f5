"""Synthetic request traffic for the serving benchmark.

The "millions of users" traffic shape is heavy-tailed: a few hot nodes
absorb most lookups.  ``zipf_node_stream`` draws node ids with
probability proportional to ``rank^-s`` over a seeded permutation of the
node set — the permutation spreads the hot ranks across communities in
proportion to community size, so on the size-skewed benchmark graphs the
big communities carry most of the request mass (the regime the
embedding cache exploits).  The port's copy of ``repro.serve.traffic``:
the same seed gives the same stream.
"""
from __future__ import annotations

import numpy as np


def zipf_node_stream(num_nodes: int, num_requests: int, s: float = 1.1,
                     seed: int = 0) -> np.ndarray:
    """(num_requests,) int32 node ids, Zipf(s)-distributed."""
    if num_nodes <= 0:
        raise ValueError(f"num_nodes must be positive, got {num_nodes}")
    rng = np.random.default_rng(seed)
    weights = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-float(s))
    probs = weights / weights.sum()
    nodes = rng.permutation(num_nodes)
    draws = rng.choice(num_nodes, size=int(num_requests), p=probs)
    return nodes[draws].astype(np.int32)
