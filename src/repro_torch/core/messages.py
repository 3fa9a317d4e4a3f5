"""Host-side (numpy) accounting of the community messages.

The port's copy of ``gather_bytes``, ``adjacency_bytes``, ``pad_stats``,
``plane_read_offsets`` and ``self_slot_mask`` from ``repro.core.messages``:
per-iteration payload bytes, device-resident adjacency bytes and
residual-padding work of a layout, and the single-plane read tables of the
serving engine.  The neighbour exchange plan and its transports come with
the multi-shard slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def gather_bytes(neighbor_mask: np.ndarray, n_pad: int,
                 feature_dims: Sequence[int], itemsize: int = 4) -> dict:
    """Collective bytes per ADMM iteration: full all-gather vs the
    neighbour-only volume the paper's topology actually needs.

    Every iteration gathers one (M, n_pad, C) payload per entry of
    ``feature_dims`` (the Z_l layers, U, and the relay aggregates q).  The
    full all-gather moves M payload rows to every agent; neighbour-aware
    exchange moves only the rows r ∈ N_m ∪ {m}, i.e. nnz(neighbor_mask)
    row-payloads in total instead of M².
    """
    nbr = np.asarray(neighbor_mask)
    m = nbr.shape[0]
    nnz = int(nbr.sum())
    per_c = n_pad * itemsize
    full = sum(m * m * c * per_c for c in feature_dims)
    needed = sum(nnz * c * per_c for c in feature_dims)
    return {"full_bytes": full, "needed_bytes": needed,
            "nnz_blocks": nnz, "dense_blocks": m * m,
            "savings_ratio": 1.0 - (needed / full if full else 0.0)}


def adjacency_bytes(neighbor_mask: np.ndarray, n_pad: int,
                    itemsize: int = 4) -> dict:
    """Device-resident adjacency bytes per representation.

    ``dense_bytes`` is the replicated-layout block tensor the parallel
    trainer shards row-wise in dense mode (M² blocks in total across the
    mesh); ``ell_bytes`` is the block-compressed (ELL) payload the
    compressed trainer holds instead — M·max_deg blocks plus the int32
    index / float32 mask planes; ``csr_bytes`` is the tighter
    CSR-of-blocks bound (nnz blocks, host-side).  ``itemsize`` is the ELL
    *block-store* element size (2 with ``adjacency_bf16``) — it scales
    only ``ell_bytes``; the dense and CSR baselines are always the f32
    tensors those representations actually are, so ``ell_ratio`` shows
    the bf16 win instead of silently halving the comparison point.  On
    power-law community graphs max_deg is ~constant in M, so ell_bytes
    grows ~linearly while dense_bytes grows quadratically.
    """
    nbr = np.asarray(neighbor_mask)
    m = nbr.shape[0]
    deg = nbr.sum(axis=1)
    max_deg = int(deg.max()) if m else 0
    nnz = int(nbr.sum())
    block = n_pad * n_pad
    dense = m * m * block * 4
    ell = m * max_deg * (block * itemsize + 4 + 4)
    return {
        "dense_bytes": dense,
        "ell_bytes": ell,
        "csr_bytes": nnz * block * 4,
        "nnz_blocks": nnz,
        "max_deg": max_deg,
        "block_itemsize": itemsize,
        "ell_ratio": ell / dense if m else 0.0,
    }


def pad_stats(neighbor_mask: np.ndarray, sizes: np.ndarray,
              row_counts: np.ndarray, n_pad: int,
              feature_dims: Sequence[int], itemsize: int = 4) -> dict:
    """Residual-padding accounting of a (possibly ragged) layout.

    ``sizes`` are the true community row counts, ``row_counts`` the padded
    counts actually processed (None = the global ``n_pad`` everywhere).
    Per ADMM iteration (one payload per entry of ``feature_dims``, the same
    convention as ``gather_bytes``):

      * ``pad_rows`` / ``pad_bytes`` — payload rows (bytes) that carry
        padding, Σ_m (row_counts[m] − sizes[m]);
      * ``pad_flops`` — MXU work the block aggregation spends on pad
        rows/cols: Σ_{(m,r)∈nbr} 2·C·(rc_m·rc_r − s_m·s_r), i.e. processed
        minus irreducible true-row FLOPs (the ELL kernel's row-count guards
        skip pad work at tile granularity; this is the row-exact bound).

    Bucketed row_counts shrink both against the global-pad baseline on any
    size-skewed partition — the drop CI guards via BENCH_speedup.json's
    ``m32_ragged`` section.
    """
    nbr = np.asarray(neighbor_mask, bool)
    s = np.asarray(sizes, dtype=np.int64)
    rc = np.full(s.shape, n_pad, dtype=np.int64) if row_counts is None \
        else np.asarray(row_counts, dtype=np.int64)
    if (rc < s).any():
        raise ValueError("row_counts below true community sizes")
    total_c = int(np.sum(list(feature_dims)))
    pad_rows = int((rc - s).sum())
    processed = float(np.outer(rc, rc)[nbr].sum())
    true = float(np.outer(s, s)[nbr].sum())
    agg_flops = 2.0 * total_c * processed
    pad_flops = 2.0 * total_c * (processed - true)
    return {
        "pad_rows": pad_rows,
        "pad_bytes": pad_rows * total_c * itemsize,
        "pad_flops": pad_flops,
        "agg_flops": agg_flops,
        "pad_flop_frac": pad_flops / agg_flops if agg_flops else 0.0,
        "padded_rows_total": int(rc.sum()),
        "true_rows_total": int(s.sum()),
    }


def plane_read_offsets(ell_indices: np.ndarray, ell_mask: np.ndarray,
                       local_offsets: np.ndarray) -> np.ndarray:
    """Resident-plane row offsets of every ELL neighbour slot.

    The single-plane twin of ``NeighborExchange.localized_offsets``: when
    every community is resident on one packed plane (serving, or a 1-shard
    mesh) there is no receive buffer to remap through — each masked-in
    (m, d) slot reads its neighbour's bucket starting at
    ``local_offsets[ell_indices[m, d]]``.  Masked-out slots map to row 0
    (in range; multiplied away by the mask).  This is the halo-read table
    the serving engine scalar-prefetches into the packed ELL kernel.
    """
    idx = np.asarray(ell_indices)
    msk = np.asarray(ell_mask) > 0
    offs = np.asarray(local_offsets, dtype=np.int32)
    return np.where(msk, offs[idx], 0).astype(np.int32)


def self_slot_mask(ell_indices: np.ndarray, ell_mask: np.ndarray
                   ) -> np.ndarray:
    """(M, max_deg) float32 marking each ELL row's *self* (diagonal) slot.

    ``ell_mask - self_slot_mask`` is then the cross-community (halo) mask:
    the serving engine aggregates the two halves separately so the halo
    part — the only part that depends on other communities — can be cached
    and invalidated on its own (kernels.ops.community_halo_spmm).
    """
    idx = np.asarray(ell_indices)
    msk = np.asarray(ell_mask) > 0
    rows = np.arange(idx.shape[0])[:, None]
    return ((idx == rows) & msk).astype(np.float32)
