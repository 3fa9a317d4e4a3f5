"""Synthetic token streams: a copy of ``synthetic_token_batches`` from
src/repro/data/synthetic.py (numpy only).

A mixture of Zipf-distributed unigrams and deterministic skip-gram
patterns, so that a model can reduce loss by learning structure.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            seed: int = 0,
                            pattern_period: int = 8) -> Iterator[dict]:
    """Yields {'tokens', 'targets'} int32 arrays forever.

    Structure: token[t] depends on token[t - pattern_period] (copy with a
    fixed offset) half the time, Zipf noise otherwise — a learnable
    long-range dependency with tunable difficulty.
    """
    rng = np.random.default_rng(seed)
    zipf_p = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    offset = 17 % vocab_size
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq_len + 1),
                          p=zipf_p).astype(np.int32)
        for t in range(pattern_period, seq_len + 1):
            copy_mask = rng.random(batch) < 0.5
            toks[copy_mask, t] = (toks[copy_mask, t - pattern_period]
                                  + offset) % vocab_size
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
