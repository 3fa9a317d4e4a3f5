"""Cross-community request batching.

A serving queue arrives as flat node ids in request order; the ELL/gather
programs want per-community row batches.  ``RequestBatcher.coalesce``
groups the queue by community (stable order, so a request's position in
its batch is deterministic) and pads each community's row-index array to
a ``graph.pad_ladder`` bucket — the same geometric {8, 16, 24, 32, 48,
...} ladder the ragged layout pads rows with — so the per-batch gather
shapes come from a small static set.  The port's copy of
``repro.serve.batcher``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import pad_ladder


@dataclasses.dataclass(frozen=True)
class CommunityBatch:
    """One community's slice of a request batch."""

    comm: int                # community id
    rows: np.ndarray         # (bucket,) int32 rows within the community
    #                          block, padded with 0 past ``count``
    count: int               # true requests in this batch
    positions: np.ndarray    # (count,) indices into the request vector

    @property
    def bucket(self) -> int:
        return int(self.rows.shape[0])


class RequestBatcher:
    """Coalesce node requests into padded per-community row batches."""

    def __init__(self, node_comm: np.ndarray, node_row: np.ndarray,
                 max_batch: int = 1024):
        """``node_comm``/``node_row``: (N,) community id and block-local
        row of every node (from ``CommunityLayout.perm``).  ``max_batch``
        bounds the per-community batch the ladder must cover."""
        self.node_comm = np.asarray(node_comm, dtype=np.int32)
        self.node_row = np.asarray(node_row, dtype=np.int32)
        self.max_batch = int(max_batch)
        self.ladder = pad_ladder(self.max_batch)

    def bucket(self, count: int) -> int:
        """Smallest ladder bucket >= ``count``."""
        if count > self.ladder[-1]:
            raise ValueError(f"batch of {count} exceeds the ladder cap "
                             f"{self.ladder[-1]} (max_batch={self.max_batch})")
        return next(v for v in self.ladder if v >= count)

    def coalesce(self, node_ids: np.ndarray) -> list[CommunityBatch]:
        """Group a request vector by community.

        Returns batches sorted by community id; each request keeps its
        queue position so the caller can scatter results back in request
        order.
        """
        ids = np.asarray(node_ids, dtype=np.int64)
        if ids.ndim != 1:
            raise ValueError(f"node_ids must be 1-D, got shape {ids.shape}")
        comms = self.node_comm[ids]
        order = np.argsort(comms, kind="stable")
        batches: list[CommunityBatch] = []
        for comm in np.unique(comms):
            pos = order[comms[order] == comm]
            rows = self.node_row[ids[pos]]
            b = self.bucket(len(pos))
            padded = np.zeros(b, dtype=np.int32)
            padded[:len(pos)] = rows
            batches.append(CommunityBatch(
                comm=int(comm), rows=padded, count=int(len(pos)),
                positions=pos.astype(np.int64)))
        return batches
