"""Community messages: byte accounting, the neighbour-exchange plan and
its loopback transport.

The port's copy of ``repro.core.messages``.  Host side (numpy), equal to
the reference table for table (tests/test_torch_messages.py):

  * ``gather_bytes``, ``adjacency_bytes``, ``pad_stats``: per-iteration
    payload bytes, device-resident adjacency bytes and residual-padding
    work of a layout;
  * ``plane_read_offsets``, ``self_slot_mask``: the single-plane read
    tables of the serving engine;
  * the neighbour-exchange plan (``NeighborExchange``,
    ``build_neighbor_exchange``, ``restrict_exchange``, ``arrival_rounds``)
    and its pricing (``exchange_bytes``, ``overlap_stats``,
    ``verify_transport_bytes``).

Two transports run the plan.  The loopback (``Loopback``:
``exchange_neighbors``, ``exchange_neighbors_packed``, ``allgather``) runs
it on one device for ``n_shards`` logical shards: the tensors carry every
shard at once, and each round of the plan — one ``lax.ppermute`` in the
reference — is a row copy from the source shard's rows into the
destination shard's receive buffer.  The process transport
(``ProcessTransport``) runs one shard per process of a
``torch.distributed`` group: its tables are the shard's own
(``process_tables``), each round is one ``batch_isend_irecv``, and the
reference's psum an all-gather summed in shard order (``fold``).  Under
an op-trace recorder (``analysis.trace``) each call records its rounds'
pairs, rows and wire bytes.

The paper's Appendix A messages (eq. 4) are functions here too:
``row_aggregate``, ``first_order_messages`` (p), ``relay_aggregate`` (q),
``second_order_from_relay`` (s², rebuilt by the receiver) and
``neighbor_preactivations``.  The trainer computes q inline, per lane.

``MeshCollectives`` holds the language models' collectives over a
``data`` × ``model`` mesh of ranks; those along a line of ranks are
``torch.autograd.Function``s whose backward pass is the dual collective
(an all-gather's a reduce-scatter or this rank's slice, a reduce-scatter's
an all-gather, a sum's the identity), so gradients flow through the
tensor-parallel layers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core.graph import shard_neighbor_graph
from repro_torch.launch.roofline import FP32_PEAK, LINK_BW
from repro_torch.sharding.partition import ring_round_coloring

Tensor = torch.Tensor

# The overlap model's device (``overlap_stats``): an H100 SXM's published
# FP32 peak (the aggregation kernels run FP32 FMAs) and one direction of
# its NVLink 4, the link between two agents' cards (``launch.roofline``).
PEAK_FLOPS = FP32_PEAK


def row_aggregate(a_row: Tensor, z_all: Tensor,
                  mask: "Tensor | None" = None) -> Tensor:
    """Σ_{r∈N_m} Ã_{m,r} Z_r — community m's first-order aggregation.

    a_row: (M, n_pad, n_pad) — m's row of Ã blocks (Ã_{m,r} for all r)
    z_all: (M, n_pad, C)     — all communities' Z (gathered)
    mask:  optional (M,) neighbour row; absent blocks contribute nothing
    returns (n_pad, C)
    """
    if mask is not None:
        a_row = a_row * mask[:, None, None].to(a_row.dtype)
    return torch.einsum("rip,rpc->ic", a_row, z_all)


def first_order_messages(a_row: Tensor, z_all: Tensor, w_next: Tensor,
                         mask: "Tensor | None" = None) -> Tensor:
    """Stacked p_{l,r→m} for all r: (M, n_pad, C_next).  p[r] = Ã_{m,r} Z_r W."""
    if mask is not None:
        a_row = a_row * mask[:, None, None].to(a_row.dtype)
    return torch.einsum("rip,rpc->ric", a_row, z_all) @ w_next


def relay_aggregate(a_row: Tensor, z_all: Tensor, w_next: Tensor,
                    mask: "Tensor | None" = None) -> Tensor:
    """q_{l,m} = (Σ_r Ã_{m,r} Z_r) W_{l+1} — the payload community m relays."""
    return row_aggregate(a_row, z_all, mask) @ w_next


def second_order_from_relay(q_all: Tensor, a_row: Tensor, z_local: Tensor,
                            w_next: Tensor) -> Tensor:
    """s²_{l,r→m} for all r, reconstructed receiver-side (eq. 4).

    q_all:   (M, n_pad, C_next) — gathered relay aggregates q_{l,r}
    a_row:   (M, n_pad, n_pad)  — Ã_{m,r}; Ã_{r,m} = Ã_{m,r}ᵀ
    z_local: (n_pad, C_l)       — Z_{l,m}
    returns  (M, n_pad, C_next)
    """
    own_contrib = torch.einsum("rnp,nc->rpc", a_row, z_local @ w_next)
    return q_all - own_contrib


def neighbor_preactivations(q_all: Tensor, a_row: Tensor, z_var: Tensor,
                            z_ref: Tensor, w_next: Tensor) -> Tensor:
    """Pre-activations of every community's next layer as a function of
    this community's ``z_var``, the others frozen at their k-th iterates
    (baked into ``q_all`` through ``z_ref``):

        pre[r] = q_{l,r} + Ã_{r,m} (z_var − z_ref) W_{l+1}
               = s²_{l,r→m} + Ã_{r,m} z_var W_{l+1}

    For r ∉ N_m the Ã block is zero, so pre[r] is constant in z_var."""
    delta = (z_var - z_ref) @ w_next
    return q_all + torch.einsum("rnp,nc->rpc", a_row, delta)


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


# ---------------------------------------------------------------------------
# the neighbour-exchange plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeRound:
    """One round of the neighbour exchange.

    Every pair of the round moves a ``(rows_pad, C)`` buffer; shards
    outside ``pairs`` move nothing.  Rows are *node* rows: a
    community contributes only its true ``sizes[r]`` rows (row-exact), or
    all ``n_pad`` rows when the plan was built without sizes (the
    global-pad / whole-block behaviour).  ``send_idx[s]`` lists the flat
    local node-row indices (into the (k·n_pad, C)-flattened local payload)
    shard s packs, 0-padded past its true row count; ``recv_slot[s]`` the
    flat receive-buffer rows (into (r_pad·n_pad, C)) the arriving rows
    scatter into, with pad positions pointing one past the buffer end so
    the scatter discards them.  For each pair both tables are
    written from the same ordered row list, so row t on the source lines up
    with row t on the destination.
    """
    offset: int                      # colour id of the round (edge colouring)
    pairs: tuple[tuple[int, int], ...]
    rows_pad: int                    # padded node rows per participating shard
    send_idx: np.ndarray             # (n_shards, rows_pad) int32 flat rows
    recv_slot: np.ndarray            # (n_shards, rows_pad) int32; OOB=drop
    true_rows: int                   # Σ real node rows over pairs (no padding)
    # packed-plane twins (plans built with row_counts): rows into the local
    # (plane_rows, C) state plane / the (recv_plane_rows, C) receive plane
    send_rows_packed: "np.ndarray | None" = None
    recv_rows_packed: "np.ndarray | None" = None


@dataclasses.dataclass(frozen=True)
class NeighborExchange:
    """Static neighbour-only exchange plan over the community topology.

    Built host-side from ``neighbor_mask`` (equivalently the per-shard
    union of ``BlockCSR.ell_indices``): shard s must end up holding the
    payload rows of ``needed_ids[s]`` — its own k lanes (resident, no
    wire) plus every neighbour community of any of its lanes.  Messages
    (src shard → dst shard, list of community ids) are coloured into
    rounds (sharding.partition.ring_round_coloring), so one exchange is
    ``len(rounds)`` static rounds moving ``(rows_pad, C)`` node-row
    buffers — no ``(M, n_pad, C)`` gathered tensor is ever materialised.  Receive
    buffers are lane-major: ``(r_pad, n_pad, C)`` with each shard's own
    lanes and neighbour rows at the slots ``localize_indices`` remaps the
    ELL indices onto.

    Row-exact mode (``sizes`` given, ``row_exact=True``): each wired
    community contributes only its true node rows, so on a size-skewed
    partition the wire volume tracks Σ sizes over cross-shard messages
    instead of (#messages)·n_pad — the pad rows never leave the device.
    Receive-buffer rows past a community's size simply stay zero, exactly
    the value the whole-block transport would have delivered.
    """
    n_shards: int
    lanes_per_shard: int
    n_pad: int
    r_pad: int                       # receive-buffer rows (max over shards)
    needed_ids: tuple[tuple[int, ...], ...]   # per shard, slot -> global id
    own_slots: np.ndarray            # (n_shards, k) int32
    rounds: tuple[ExchangeRound, ...]
    sizes: tuple[int, ...] = ()      # per community wired rows (n_pad if not
    row_exact: bool = False          # row-exact)
    # packed-plane metadata (plans built with row_counts): the send side is
    # the shard's (plane_rows, C) state plane (PackedDeviceLayout); the
    # receive side a (recv_plane_rows, C) plane with slot j's community at
    # recv_offsets[s, j] for row_counts[gid] bucket rows
    row_counts: tuple[int, ...] = ()
    plane_rows: int = 0
    recv_plane_rows: int = 0
    local_offsets: "np.ndarray | None" = None   # (M,) row in the home plane
    recv_offsets: "np.ndarray | None" = None    # (n_shards, r_pad); OOB=unused
    own_copy_rows: "np.ndarray | None" = None   # (n_shards, recv_plane_rows)
    recv_unpack_rows: "np.ndarray | None" = None  # (n_shards, r_pad·n_pad)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def packed(self) -> bool:
        """True when the plan carries packed-plane routing tables."""
        return self.recv_offsets is not None

    def slot_of(self, shard: int) -> dict[int, int]:
        """global community id -> receive-buffer slot on ``shard``."""
        return {int(r): i for i, r in enumerate(self.needed_ids[shard])}

    def localize_indices(self, ell_indices: np.ndarray,
                         ell_mask: np.ndarray) -> np.ndarray:
        """Remap global ELL neighbour ids to receive-buffer slots.

        ``ell_indices``: (M, max_deg) global community ids (community-major
        rows, as BlockCSR stores them).  Row m belongs to shard m // k;
        every masked-in id is in that shard's needed set by construction.
        Masked-out (padding) entries map to slot 0 — they are multiplied by
        the zero mask by every consumer, any in-range slot is fine.
        """
        idx = np.asarray(ell_indices)
        msk = np.asarray(ell_mask) > 0
        k = self.lanes_per_shard
        slot_tables = [self.slot_of(s) for s in range(self.n_shards)]
        out = np.zeros_like(idx, dtype=np.int32)
        for m in range(idx.shape[0]):
            slots = slot_tables[m // k]
            for d in np.flatnonzero(msk[m]):
                out[m, d] = slots[int(idx[m, d])]
        return out

    def localized_offsets(self, ell_indices: np.ndarray,
                          ell_mask: np.ndarray) -> np.ndarray:
        """Receive-plane *row offsets* of every ELL neighbour slot.

        The packed twin of ``localize_indices``: instead of a buffer slot
        (a multiple-of-``n_pad`` stride), each masked-in (m, d) entry maps
        to the first receive-plane row of its neighbour's bucket —
        ``recv_offsets[shard(m), slot]`` — which is what the offset-indexed
        ELL kernel reads to address its Z rows.  Masked-out
        entries map to row 0 (in range, multiplied away by the mask).
        """
        if self.recv_offsets is None:
            raise ValueError("plan built without row_counts has no packed "
                             "receive plane — pass row_counts to "
                             "build_neighbor_exchange")
        loc = self.localize_indices(ell_indices, ell_mask)
        msk = np.asarray(ell_mask) > 0
        k = self.lanes_per_shard
        out = np.zeros_like(loc, dtype=np.int32)
        for m in range(loc.shape[0]):
            offs = self.recv_offsets[m // k]
            for d in np.flatnonzero(msk[m]):
                out[m, d] = offs[loc[m, d]]
        return out


def build_neighbor_exchange(neighbor_mask: np.ndarray, n_shards: int,
                            n_pad: int,
                            sizes: np.ndarray | None = None,
                            row_counts: np.ndarray | None = None
                            ) -> NeighborExchange:
    """Construct the static round schedule for a community topology.

    ``sizes`` (optional, (M,) true rows per community) switches the plan to
    row-exact packing: each cross-shard message carries only the true node
    rows of its communities.  Without it every community wires all
    ``n_pad`` rows — byte-identical to the historic whole-block schedule.

    ``row_counts`` (optional, (M,) bucket rows per community,
    ``CommunityLayout.eff_row_counts``) additionally equips the plan with
    *packed-plane* routing tables: send rows index the shard's packed
    Σ-bucket-rows state plane (``PackedDeviceLayout``) and receive rows a
    packed receive plane with one bucket per needed slot, so a packed
    trainer never materialises a strided ``(r_pad, n_pad, C)`` buffer on
    the wire path.  The wired rows themselves are unchanged — packed and
    strided plans schedule byte-identical rounds.
    """
    nbr = np.asarray(neighbor_mask, bool)
    m = nbr.shape[0]
    needed, _ = shard_neighbor_graph(nbr, n_shards)
    k = m // n_shards
    row_exact = sizes is not None
    wired = np.full(m, n_pad, dtype=np.int64) if sizes is None \
        else np.asarray(sizes, dtype=np.int64)
    if wired.shape != (m,) or (wired < 0).any() or (wired > n_pad).any():
        raise ValueError(f"sizes must be (M,) in [0, n_pad={n_pad}]")
    r_pad = max(len(ids) for ids in needed)
    slot_of = [{int(r): i for i, r in enumerate(ids)} for ids in needed]

    packed = row_counts is not None
    if packed:
        rc = np.asarray(row_counts, dtype=np.int64)
        if rc.shape != (m,) or (rc > n_pad).any() or (rc < wired).any():
            raise ValueError("row_counts must be (M,) in [wired rows, "
                             f"n_pad={n_pad}] — buckets cover what is wired")
        local_offsets = np.zeros(m, dtype=np.int32)
        for s in range(n_shards):
            local_offsets[s * k:(s + 1) * k] = np.concatenate(
                [[0], np.cumsum(rc[s * k:(s + 1) * k])[:-1]])
        plane_rows = max(int(rc.reshape(n_shards, k).sum(axis=1).max()), 8)
        recv_offsets = np.full((n_shards, r_pad), 0, dtype=np.int32)
        recv_rows = np.zeros(n_shards, dtype=np.int64)
        for s in range(n_shards):
            cnts = [int(rc[g]) for g in needed[s]]
            offs = np.concatenate([[0], np.cumsum(cnts)]).astype(np.int32)
            recv_offsets[s, :len(cnts)] = offs[:-1]
            recv_rows[s] = offs[-1]
        recv_plane_rows = max(int(recv_rows.max()), 8)
        # unused trailing slots point one past the plane (drop/fill)
        for s in range(n_shards):
            recv_offsets[s, len(needed[s]):] = recv_plane_rows
        own_copy_rows = np.full((n_shards, recv_plane_rows), plane_rows,
                                dtype=np.int32)
        recv_unpack = np.full((n_shards, r_pad * n_pad), recv_plane_rows,
                              dtype=np.int32)
        for s in range(n_shards):
            for slot, gid in enumerate(needed[s]):
                cnt = int(rc[gid])
                rows = np.arange(cnt)
                recv_unpack[s, slot * n_pad: slot * n_pad + cnt] = \
                    recv_offsets[s, slot] + rows
                if gid // k == s:           # resident lane: local plane copy
                    own_copy_rows[s, recv_offsets[s, slot]:
                                  recv_offsets[s, slot] + cnt] = \
                        local_offsets[gid] + rows
    else:
        rc = None
        local_offsets = recv_offsets = own_copy_rows = recv_unpack = None
        plane_rows = recv_plane_rows = 0

    own_slots = np.zeros((n_shards, k), dtype=np.int32)
    for s in range(n_shards):
        for i in range(k):
            own_slots[s, i] = slot_of[s][s * k + i]

    # messages grouped by ring offset; ids kept sorted per (src, dst) pair
    msgs: dict[tuple[int, int], list[int]] = {}
    for dst in range(n_shards):
        for r in needed[dst]:
            src = int(r) // k
            if src != dst:
                msgs.setdefault((src, dst), []).append(int(r))
    colored = ring_round_coloring(msgs.keys(), n_shards)

    def msg_rows(pair):                 # true node rows of one message
        return int(sum(wired[r] for r in msgs[pair]))

    rounds = []
    for offset, pairs in colored.items():
        # Row-exact plans may split a colour round into power-of-two
        # size-bucketed sub-rounds: every round's buffer pads to its
        # largest message, so letting a 10-row and a 500-row message share
        # a round would wire 490 pad rows — grouping pairs whose row
        # counts share a bucket bounds round padding by the bucket ratio
        # (< 2×) instead of the offset's largest message.  Each sub-round
        # is a subset of a partial permutation, hence still one.  The
        # split is taken only when it at least halves the round's
        # scheduled wire: each extra round is one more send buffer that
        # every shard materialises, so on near-uniform
        # message sizes (where padding is small anyway) one round per
        # offset stays cheaper end-to-end.  Whole-block plans always keep
        # one round per offset (all messages are count·n_pad rows — the
        # historic schedule, byte-identical).
        grouped = [list(pairs)]
        if row_exact:
            groups: dict[int, list] = {}
            for p in pairs:
                rows = msg_rows(p)
                bucket = 1 << max(0, int(np.ceil(np.log2(max(1, rows)))))
                groups.setdefault(bucket, []).append(p)
            split = [grp for _, grp in sorted(groups.items())]
            plain_wire = len(pairs) * max(msg_rows(p) for p in pairs)
            split_wire = sum(len(g) * max(msg_rows(p) for p in g)
                             for g in split)
            if 2 * split_wire <= plain_wire:
                grouped = split
        for grp in grouped:
            rows_pad = max(msg_rows(p) for p in grp)
            if rows_pad == 0:
                continue                # all-empty messages: nothing to wire
            send_idx = np.zeros((n_shards, rows_pad), dtype=np.int32)
            recv_slot = np.full((n_shards, rows_pad), r_pad * n_pad,
                                dtype=np.int32)
            send_pk = np.zeros((n_shards, rows_pad), dtype=np.int32) \
                if packed else None
            recv_pk = np.full((n_shards, rows_pad), recv_plane_rows,
                              dtype=np.int32) if packed else None
            for src, dst in grp:
                t = 0
                for r in msgs[(src, dst)]:
                    rows = int(wired[r])
                    send_idx[src, t:t + rows] = \
                        (r - src * k) * n_pad + np.arange(rows)
                    recv_slot[dst, t:t + rows] = \
                        slot_of[dst][r] * n_pad + np.arange(rows)
                    if packed:
                        send_pk[src, t:t + rows] = \
                            local_offsets[r] + np.arange(rows)
                        recv_pk[dst, t:t + rows] = \
                            recv_offsets[dst, slot_of[dst][r]] \
                            + np.arange(rows)
                    t += rows
            rounds.append(ExchangeRound(
                offset=offset, pairs=tuple(grp), rows_pad=rows_pad,
                send_idx=send_idx, recv_slot=recv_slot,
                true_rows=sum(msg_rows(p) for p in grp),
                send_rows_packed=send_pk, recv_rows_packed=recv_pk))

    return NeighborExchange(
        n_shards=n_shards, lanes_per_shard=k, n_pad=n_pad, r_pad=r_pad,
        needed_ids=tuple(tuple(int(r) for r in ids) for ids in needed),
        own_slots=own_slots, rounds=tuple(rounds),
        sizes=tuple(int(v) for v in wired), row_exact=row_exact,
        row_counts=tuple(int(v) for v in rc) if packed else (),
        plane_rows=plane_rows, recv_plane_rows=recv_plane_rows,
        local_offsets=local_offsets, recv_offsets=recv_offsets,
        own_copy_rows=own_copy_rows, recv_unpack_rows=recv_unpack)


def restrict_exchange(plan: NeighborExchange,
                      sampled_shards) -> NeighborExchange:
    """Sampled-round sub-schedule: the plan restricted to the pairs a
    community minibatch actually reads.

    Under stochastic community minibatching only the *sampled* shards'
    subproblems run, so only they need to receive — a pair
    ``(src, dst)`` survives iff ``dst`` is sampled.  The source side is
    NOT filtered: an unsampled neighbour's (stale, exact) Z/U rows still
    feed every sampled consumer's coupling terms, so unsampled shards
    keep sending.  Unsampled edges — pairs into unsampled shards — carry
    zero wire: their rounds either shrink or vanish.

    Buffer geometry is untouched (``needed_ids``/slots/``r_pad``/packed
    plane tables), so ELL indices and offsets localized against the full
    plan stay valid on the sub-schedule; rows a dropped pair would have
    delivered simply stay zero, values an unsampled consumer never
    reads.  Kept rounds re-pad to their largest surviving message and
    all-dropped rounds disappear, so ``exchange_bytes`` on the sub-plan
    prices exactly the sampled wire.  Restricting to the full shard set
    returns ``plan`` itself — the full-batch step is the
    batch_fraction=1.0 step, bit for bit.
    """
    sampled = frozenset(int(s) for s in sampled_shards)
    if not sampled:
        raise ValueError("sampled_shards must be non-empty")
    if not sampled <= set(range(plan.n_shards)):
        raise ValueError(f"sampled shards {sorted(sampled)} out of range "
                         f"for n_shards={plan.n_shards}")
    if len(sampled) == plan.n_shards:
        return plan
    limit = plan.r_pad * plan.n_pad
    rounds = []
    for rnd in plan.rounds:
        kept = tuple(p for p in rnd.pairs if p[1] in sampled)
        if not kept:
            continue
        # per-pair true rows: a round is a partial permutation, so each
        # destination receives exactly one message — its in-range
        # recv_slot entries count that message's rows
        rows_of = {p: int((rnd.recv_slot[p[1]] < limit).sum())
                   for p in kept}
        rows_pad = max(rows_of.values())
        if rows_pad == 0:
            continue
        rounds.append(ExchangeRound(
            offset=rnd.offset, pairs=kept, rows_pad=rows_pad,
            send_idx=rnd.send_idx[:, :rows_pad],
            recv_slot=rnd.recv_slot[:, :rows_pad],
            true_rows=sum(rows_of.values()),
            send_rows_packed=None if rnd.send_rows_packed is None
            else rnd.send_rows_packed[:, :rows_pad],
            recv_rows_packed=None if rnd.recv_rows_packed is None
            else rnd.recv_rows_packed[:, :rows_pad]))
    return dataclasses.replace(plan, rounds=tuple(rounds))


# ---------------------------------------------------------------------------
# the loopback transport: every shard's rows on one device
# ---------------------------------------------------------------------------

def bf16_wire(payload: Tensor) -> Tensor:
    """``payload`` as it arrives over the bf16 wire: an f32 payload rounded
    to bf16 (to nearest even) and restored to f32; any other dtype moves
    as it is."""
    if payload.dtype != torch.float32:
        return payload
    return payload.to(torch.bfloat16).to(torch.float32)


def loopback_tables(plan: NeighborExchange, device: torch.device) -> dict:
    """The plan's row tables as index tensors on ``device``: build them
    once per plan and pass them to the exchanges (``tables=``).

    Shard s's rows sit at ``s · rows_per_shard`` of every stacked tensor,
    and each scatter target has one scratch row past its end: a receive
    position the reference drops (``mode="drop"``, pad rows one past the
    buffer) lands there and is sliced off, never in a real row.
    """
    s_n, k, n = plan.n_shards, plan.lanes_per_shard, plan.n_pad
    sid = np.arange(s_n)[:, None]

    def dev(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    limit = plan.r_pad * n
    own = plan.own_slots.astype(np.int64)[:, :, None] * n + np.arange(n)
    tables = {
        "own_dst": dev(sid * (limit + 1) + own.reshape(s_n, k * n)),
        "rounds": [],
    }
    for rnd in plan.rounds:
        src = np.array([p[0] for p in rnd.pairs])
        dst = np.array([p[1] for p in rnd.pairs])
        tables["rounds"].append((
            dev(src[:, None] * (k * n) + rnd.send_idx[src]),
            dev(dst[:, None] * (limit + 1) + rnd.recv_slot[dst])))
    if plan.packed:
        rpr, pr = plan.recv_plane_rows, plan.plane_rows
        own_rows = plan.own_copy_rows.astype(np.int64)
        live = own_rows < pr
        tables["own_plane_dst"] = dev(np.nonzero(live.reshape(-1))[0])
        tables["own_plane_src"] = dev((sid * pr + own_rows)[live])
        tables["plane_rounds"] = []
        for rnd in plan.rounds:
            src = np.array([p[0] for p in rnd.pairs])
            dst = np.array([p[1] for p in rnd.pairs])
            recv = rnd.recv_rows_packed[dst].astype(np.int64)
            tables["plane_rounds"].append((
                dev(src[:, None] * pr + rnd.send_rows_packed[src]),
                dev(np.where(recv < rpr, dst[:, None] * rpr + recv,
                             s_n * rpr))))
    return tables


def exchange_neighbors(plan: NeighborExchange, x: Tensor,
                       comm_bf16: bool = False,
                       tables: "dict | None" = None) -> Tensor:
    """Run the plan for every shard at once: the stacked local payloads
    (n_shards · k, n_pad, C) -> the receive buffers (n_shards, r_pad,
    n_pad, C).

    Shard s's buffer holds exactly the payload rows its subproblems read:
    its own lanes copied at ``own_slots[s]``, neighbour rows delivered by
    the rounds at the slots ``localize_indices`` remaps the ELL indices
    onto, every other row zero.  With ``comm_bf16`` only the rows that
    cross the wire are rounded to bf16 (``bf16_wire``); own rows stay f32.
    ``tables`` are the plan's ``loopback_tables`` (built here when None).
    """
    s_n, k, n = plan.n_shards, plan.lanes_per_shard, plan.n_pad
    feat = tuple(x.shape[2:])
    if s_n == 1:
        # one shard hosts every community: its slots are its lanes
        return x[None]
    t = tables if tables is not None else loopback_tables(plan, x.device)
    x_flat = x.reshape((s_n * k * n,) + feat)
    limit = plan.r_pad * n
    buf = x.new_zeros((s_n * (limit + 1),) + feat)
    buf[t["own_dst"].reshape(-1)] = x_flat
    for send, recv in t["rounds"]:
        payload = x_flat[send.reshape(-1)]
        buf[recv.reshape(-1)] = bf16_wire(payload) if comm_bf16 else payload
    buf = buf.reshape((s_n, limit + 1) + feat)[:, :limit]
    out = buf.reshape((s_n, plan.r_pad, n) + feat)
    if trace.RECORDER is not None:
        _record("exchange", plan, t["rounds"], x, out, feat, comm_bf16)
    return out


def _record(kind: str, plan: NeighborExchange, rounds, x: Tensor, out,
            feat: tuple, comm_bf16: bool) -> None:
    """One transport event: each round's pairs, rows and wire bytes."""
    item = 2 if comm_bf16 else x.element_size()
    row = math.prod(feat) * item
    trace.RECORDER.transport(
        kind, x, out, [(rnd.pairs, send.numel(), send.numel() * row)
                       for rnd, (send, _) in zip(plan.rounds, rounds)], item)


def exchange_neighbors_packed(plan: NeighborExchange, x_plane: Tensor,
                              comm_bf16: bool = False, staged: bool = False,
                              tables: "dict | None" = None):
    """Run the plan on the stacked packed state planes: (n_shards ·
    plane_rows, C) -> the receive planes laid end to end, (n_shards ·
    recv_plane_rows, C).

    Shard s's receive plane starts at row s · recv_plane_rows and holds slot
    j's bucket rows at ``recv_offsets[s, j]``: own lanes copied from the
    shard's state plane, neighbour rows delivered by the same rounds as
    ``exchange_neighbors`` (same pairs, same rows).  With ``staged=True``
    the buffer after each stage is returned as a list, ``[after the own
    copy, after round 0, ..., final]``, each its own tensor, so that a
    consumer can aggregate the slots already delivered
    (``arrival_rounds``).  ``tables`` as in ``exchange_neighbors``.
    """
    if plan.recv_offsets is None:
        raise ValueError("plan built without row_counts cannot route the "
                         "packed plane")
    if plan.n_shards == 1:
        # one shard hosts every community and the needed-ids slot order is
        # the lane order, so the receive plane IS the local plane
        return [x_plane] if staged else x_plane
    t = tables if tables is not None \
        else loopback_tables(plan, x_plane.device)
    rows = plan.n_shards * plan.recv_plane_rows
    feat = tuple(x_plane.shape[1:])
    buf = x_plane.new_zeros((rows + 1,) + feat)
    buf[t["own_plane_dst"]] = x_plane[t["own_plane_src"]]
    stages = [buf[:rows]]
    for send, recv in t["plane_rounds"]:
        payload = x_plane[send.reshape(-1)]
        if comm_bf16:
            payload = bf16_wire(payload)
        if staged:
            buf = buf.index_put((recv.reshape(-1),), payload)
            stages.append(buf[:rows])
        else:
            buf[recv.reshape(-1)] = payload
    out = stages if staged else buf[:rows]
    if trace.RECORDER is not None:
        _record("exchange_packed", plan, t["plane_rounds"], x_plane, out,
                feat, comm_bf16)
    return out


def allgather(x: Tensor, comm_bf16: bool = False) -> Tensor:
    """The all-gather transport for every shard at once: each shard
    receives every community's rows (M, n_pad, C), so one copy serves them
    all.  The reference masks a shard's copy down to its lanes'
    neighbourhoods; a lane reads only its neighbours' rows, which that mask
    keeps, so the copy goes unmasked.  With ``comm_bf16`` every row travels
    bf16, the shard's own rows too, as in the reference.  A recorded event
    carries one shard's copy (the rules count it once per shard)."""
    out = bf16_wire(x) if comm_bf16 else x
    if trace.RECORDER is not None:
        item = 2 if comm_bf16 else x.element_size()
        trace.RECORDER.transport("allgather", x, out,
                                 [((), x.shape[0], x.numel() * item)], item)
    return out


def fold(parts: Sequence[Tensor]) -> Tensor:
    """Σ of ``parts`` in their order, ((p0 + p1) + p2) + …: the one
    summation order every psum of the port uses."""
    return sum(parts[1:], parts[0])


class Loopback:
    """The loopback transport: every shard's lanes on this device, each
    round of the plan a row copy (``exchange_neighbors``,
    ``exchange_neighbors_packed``, ``allgather``) and the psum a sum of
    the shards' parts in shard order."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.shards = tuple(range(n_shards))

    def tables(self, plan: NeighborExchange, device: torch.device) -> dict:
        return loopback_tables(plan, device)

    def exchange(self, plan, x, comm_bf16, tables):
        with trace.span("comm.exchange"):
            return exchange_neighbors(plan, x, comm_bf16, tables=tables)

    def exchange_packed(self, plan, x_plane, comm_bf16, staged, tables):
        with trace.span("comm.exchange"):
            return exchange_neighbors_packed(plan, x_plane, comm_bf16,
                                             staged=staged, tables=tables)

    def allgather(self, x, comm_bf16):
        with trace.span("comm.allgather"):
            return allgather(x, comm_bf16)

    def flush(self) -> None:
        pass


# ---------------------------------------------------------------------------
# the process transport: one shard per process, over torch.distributed
# ---------------------------------------------------------------------------

def process_tables(plan: NeighborExchange, rank: int,
                   device: torch.device) -> dict:
    """Shard ``rank``'s rows of the plan as index tensors on ``device``:
    the per-shard form of ``loopback_tables`` (nothing shifted by s ·
    rows).  Each scatter target has one scratch row past its end, where
    the reference's dropped receive positions land.

    ``rounds`` (and ``plane_rounds`` on a packed plan) hold one entry per
    round of the plan this rank takes part in: ``(round index, pairs,
    rows_pad, dst, send rows, src, receive rows)`` with ``dst`` / ``src``
    None where the rank sends or receives nothing in that round.  A round
    without the rank is left out: it does nothing there.
    """
    n, limit = plan.n_pad, plan.r_pad * plan.n_pad

    def dev(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    def rounds_of(send_tab, recv_tab):
        out = []
        for ri, rnd in enumerate(plan.rounds):
            dst = next((d for s, d in rnd.pairs if s == rank), None)
            src = next((s for s, d in rnd.pairs if d == rank), None)
            if dst is None and src is None:
                continue
            out.append((ri, rnd.pairs, rnd.rows_pad, dst,
                        None if dst is None else dev(send_tab(rnd)[rank]),
                        src,
                        None if src is None else dev(recv_tab(rnd)[rank])))
        return out

    own = plan.own_slots[rank].astype(np.int64)[:, None] * n + np.arange(n)
    tables = {"own_dst": dev(own.reshape(-1)), "limit": limit,
              "rounds": rounds_of(lambda r: r.send_idx,
                                  lambda r: r.recv_slot)}
    if plan.packed:
        own_rows = plan.own_copy_rows[rank].astype(np.int64)
        live = own_rows < plan.plane_rows
        tables["own_plane_dst"] = dev(np.nonzero(live)[0])
        tables["own_plane_src"] = dev(own_rows[live])
        tables["plane_rounds"] = rounds_of(lambda r: r.send_rows_packed,
                                           lambda r: r.recv_rows_packed)
    return tables


def gather_parts(mesh, x: Tensor, root: "int | None" = None):
    """Every rank's ``x`` in rank order (``dist.all_gather``), or with
    ``root`` only on that rank (``dist.gather``; None elsewhere), each part
    on ``x``'s device.  Over gloo a CUDA tensor is staged through the host:
    gloo's collectives take host tensors."""
    import torch.distributed as dist
    stage = mesh.backend == "gloo" and x.device.type == "cuda"
    # a 0-dim value travels as one element
    send = x.detach().reshape(-1)
    if stage:
        with trace.marked("transport-staging"):
            send = send.cpu()
    else:
        send = send.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.world_size)] \
        if root is None or mesh.rank == root else None
    if root is None:
        dist.all_gather(parts, send, group=mesh.group)
    else:
        dist.gather(send, parts, dst=root, group=mesh.group)
        if parts is None:
            return None
    return [p.to(x.device).reshape(x.shape) for p in parts]


class _Stages:
    """The staged receive plane of one exchange, stage g made when it is
    first read: after the wait on round g − 1's requests, so that a
    consumer aggregates the slots stage g − 1 delivered while later rounds
    are still in flight.  ``[after the own copy, after round 0, …,
    final]``, as ``exchange_neighbors_packed(staged=True)`` returns."""

    def __init__(self, transport, first: Tensor, posted: list, rows: int):
        self._t, self._posted, self._rows = transport, posted, rows
        self._bufs = [first]
        self._n = len(posted) + 1

    def __len__(self) -> int:
        return self._n

    def _fill(self, upto: int) -> None:
        while len(self._bufs) <= upto:
            buf = self._t._land(self._bufs[-1],
                                self._posted[len(self._bufs) - 1],
                                in_place=False)
            self._bufs.append(buf)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        j = i + self._n if i < 0 else i
        if not 0 <= j < self._n:
            raise IndexError(i)
        self._fill(j)
        return self._bufs[j][:self._rows]

    def __iter__(self):
        return (self[j] for j in range(self._n))

    def done(self) -> None:
        self._fill(self._n - 1)


class ProcessTransport:
    """The reference's per-shard exchange (``exchange_neighbors``,
    ``exchange_neighbors_packed`` under ``shard_map``) and all-gather for
    the one shard this process hosts, over ``torch.distributed``: each
    round of the plan is one ``dist.batch_isend_irecv`` of at most one send
    and one receive, where the reference runs one ``lax.ppermute``.

    Over gloo on a card the rows are staged through pinned host buffers
    (gloo's point-to-point takes host tensors); the staging copies' time
    is kept apart (``staging_s``) from the transport's whole time
    (``time_s``).  With ``comm_bf16`` the wire carries a bf16 tensor,
    widened to f32 on receipt (the bits of ``bf16_wire``).  Every round of
    an exchange is posted at once; with ``staged`` each stage waits only
    on its own round.  ``sent_bytes`` counts the bytes this rank sends.
    The psum (``psum``) is an all-gather of every rank's part and a sum in
    rank order (``fold``), so every rank holds the same bits."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank, self.n_shards = mesh.rank, mesh.world_size
        self.shards = (mesh.rank,)
        self.group, self.device = mesh.group, mesh.device
        self.stage = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self.sent_bytes = 0
        self.time_s = 0.0
        self.staging_s = 0.0
        self._seq = 0
        self._open: list = []

    def tables(self, plan: NeighborExchange, device: torch.device) -> dict:
        return process_tables(plan, self.rank, device)

    # -- the transport's clock -----------------------------------------------

    @staticmethod
    def _start(name: str) -> int:
        """The clock at the start of a region ``time_s`` counts (ns); in a
        span log the region is the span ``name``, on the same readings."""
        t0 = time.perf_counter_ns()
        if trace.SPANS is not None:
            trace.SPANS.open(name, t0)
        return t0

    def _stop(self, t0: int) -> None:
        t1 = time.perf_counter_ns()
        self.time_s += (t1 - t0) * 1e-9
        if trace.SPANS is not None:
            trace.SPANS.close(t1)

    # -- the rounds ----------------------------------------------------------

    def _to_host(self, x: Tensor) -> Tensor:
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        with trace.marked("transport-staging"):
            host.copy_(x)
        self.staging_s += time.perf_counter() - t0
        return host

    def _post(self, rounds, x_flat: Tensor, comm_bf16: bool) -> list:
        """Post every round's send and receive; one entry per round:
        (requests, receive buffer, receive rows)."""
        import torch.distributed as dist
        feat = tuple(x_flat.shape[1:])
        wire_dt = torch.bfloat16 if comm_bf16 and \
            x_flat.dtype == torch.float32 else x_flat.dtype
        seq, self._seq = self._seq, self._seq + 1
        posted = []
        for ri, _, rows_pad, dst, send, src, recv in rounds:
            tag = (seq % 65536) * 4096 + ri
            ops, rbuf = [], None
            if dst is not None:
                payload = x_flat[send].to(wire_dt)
                if self.stage:
                    payload = self._to_host(payload)
                ops.append(dist.P2POp(dist.isend, payload, dst,
                                      group=self.group, tag=tag))
                self.sent_bytes += payload.numel() * payload.element_size()
            if src is not None:
                rbuf = torch.empty((rows_pad,) + feat, dtype=wire_dt,
                                   pin_memory=self.stage,
                                   device="cpu" if self.stage
                                   else self.device)
                ops.append(dist.P2POp(dist.irecv, rbuf, src,
                                      group=self.group, tag=tag))
            posted.append((dist.batch_isend_irecv(ops), rbuf, recv,
                           x_flat.dtype))
        return posted

    def _land(self, buf: Tensor, posted, in_place: bool) -> Tensor:
        """Wait on one round and scatter what it delivered into ``buf``
        (in place, or into a copy for a staged exchange)."""
        t0 = self._start("comm.exchange")
        reqs, rbuf, recv, dtype = posted
        for q in reqs:
            q.wait()
        if rbuf is not None:
            if self.stage:
                t1 = time.perf_counter()
                rbuf = rbuf.to(self.device)
                self.staging_s += time.perf_counter() - t1
            rbuf = rbuf.to(dtype)
            if in_place:
                buf[recv] = rbuf
            else:
                buf = buf.index_put((recv,), rbuf)
        self._stop(t0)
        return buf

    def _record(self, kind, rounds, x, out, feat, comm_bf16) -> None:
        item = 2 if comm_bf16 else x.element_size()
        row = math.prod(feat) * item
        trace.RECORDER.transport(
            kind, x, out,
            [(pairs, 0 if send is None else send.numel(),
              0 if send is None else send.numel() * row)
             for _, pairs, _, _, send, _, _ in rounds], item)

    def exchange(self, plan: NeighborExchange, x: Tensor, comm_bf16: bool,
                 tables: dict) -> Tensor:
        """This shard's local payload (k, n_pad, C) -> its receive buffer
        (r_pad, n_pad, C): own lanes at ``own_slots[rank]``, neighbour rows
        from the rounds; own rows stay f32 under ``comm_bf16``."""
        t0 = self._start("comm.exchange")
        n, feat = plan.n_pad, tuple(x.shape[2:])
        x_flat = x.reshape((-1,) + feat)
        limit = tables["limit"]
        buf = x.new_zeros((limit + 1,) + feat)
        buf[tables["own_dst"]] = x_flat
        posted = self._post(tables["rounds"], x_flat, comm_bf16)
        self._stop(t0)
        for p in posted:
            buf = self._land(buf, p, in_place=True)
        out = buf[:limit].reshape((plan.r_pad, n) + feat)
        if trace.RECORDER is not None:
            self._record("exchange", tables["rounds"], x, out, feat,
                         comm_bf16)
        return out

    def exchange_packed(self, plan: NeighborExchange, x_plane: Tensor,
                        comm_bf16: bool, staged: bool, tables: dict):
        """This shard's state plane (plane_rows, C) -> its receive plane
        (recv_plane_rows, C), or with ``staged`` its stages (``_Stages``)."""
        t0 = self._start("comm.exchange")
        rows, feat = plan.recv_plane_rows, tuple(x_plane.shape[1:])
        buf = x_plane.new_zeros((rows + 1,) + feat)
        buf[tables["own_plane_dst"]] = x_plane[tables["own_plane_src"]]
        posted = self._post(tables["plane_rounds"], x_plane, comm_bf16)
        self._stop(t0)
        if staged:
            out = _Stages(self, buf, posted, rows)
            self._open.append(out)
        else:
            for p in posted:
                buf = self._land(buf, p, in_place=True)
            out = buf[:rows]
        if trace.RECORDER is not None:
            self._record("exchange_packed", tables["plane_rounds"], x_plane,
                         out if not staged else out[0], feat, comm_bf16)
        return out

    def allgather(self, x: Tensor, comm_bf16: bool) -> Tensor:
        """Every shard's lanes, (M, n_pad, C) in community order: one
        ``dist.all_gather`` of this shard's (k, n_pad, C); with
        ``comm_bf16`` every row travels bf16, this shard's own too, as in
        the reference."""
        t0 = self._start("comm.allgather")
        wire = x.to(torch.bfloat16) if comm_bf16 and \
            x.dtype == torch.float32 else x
        out = torch.cat(gather_parts(self.mesh, wire)).to(x.dtype)
        # this rank's lanes reach every rank (its own copy counted, as the
        # reference's full_bytes counts every agent's copy)
        self.sent_bytes += self.n_shards * wire.numel() * wire.element_size()
        self._stop(t0)
        if trace.RECORDER is not None:
            item = wire.element_size()
            trace.RECORDER.transport("allgather", x, out,
                                     [((), out.shape[0],
                                       out.numel() * item)], item)
        return out

    def psum(self, part: Tensor) -> Tensor:
        """Σ over the ranks of ``part``: all-gathered, summed in rank
        order, the same bits on every rank."""
        t0 = self._start("comm.sum")
        out = fold(gather_parts(self.mesh, part))
        self._stop(t0)
        if trace.RECORDER is not None:
            trace.RECORDER.shard_sum([part], out)
        return out

    def flush(self) -> None:
        """Wait on every round a staged exchange left in flight."""
        for st in self._open:
            st.done()
        self._open.clear()


# ---------------------------------------------------------------------------
# the language models' collectives over a data × model mesh of ranks
# ---------------------------------------------------------------------------

BUCKET_BYTES = 128 << 20
# MeshCollectives' byte counters, ``<name>_bytes``
COUNTERS = ("model", "a2a", "line", "sum", "sent")


def _pack(tensors: Sequence[Tensor]) -> Tensor:
    """The tensors' bytes, one flat uint8 tensor (in order)."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: Tensor, like: Sequence[tuple]) -> list:
    """``_pack``'s inverse for ``like`` = [(shape, dtype), …]."""
    out, off = [], 0
    for shape, dtype in like:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out.append(flat[off:off + n].clone().view(dtype).reshape(shape))
        off += n
    return out


@dataclasses.dataclass
class MeshCollectives:
    """The collectives a language model's ranks need on a ``data`` ×
    ``model`` mesh (``launch.mesh.ProcessMesh``): a sum over the data axes
    (``sum_data``), point-to-point messages to the neighbours along
    ``model`` (``shift``), and the tensor-parallel layers' collectives
    along ``model``: an all-gather (``gather_model``), a sum that every
    rank forms in rank order from the gathered parts (``sum_model``) and
    its reduce-scatter form (``reduce_scatter_model``), and the
    expert-parallel ``all_to_all_model``; ``gather_line`` gathers along
    any axis (the placement's inverse) and ``mean_world`` averages a
    scalar over every rank.  Over gloo on a card all of them stage through
    pinned host buffers (gloo takes host tensors), and move bytes (a
    ``uint8`` view) so every dtype travels.  It counts what it moved:
    ``sum_bytes`` (this rank's parts summed over data), ``sent_bytes``
    (sent along model by ``shift``), the bytes that leave this rank along
    ``model`` in the all-to-alls (``a2a_bytes``) and in its other
    collectives (``model_bytes``), those of all-gathers along any other
    line (``line_bytes``: the FSDP leg's slices over data, an
    all-to-all's token groups over the whole mesh), the host seconds in
    each (``sum_s``, ``shift_s``, ``a2a_s``, ``model_s``, ``line_s``) and,
    of them, in staging copies (``staging_s``), and the collectives that
    moved the bytes of each counter (``calls``).

    Gradients (the tensor-parallel training step): ``gather_line`` /
    ``gather_model`` take ``back``, the caller's word for what the ranks do
    with the gathered tensor — ``"scatter"`` where each rank then does its
    own part of the work (the gradients are partial: summed in rank order
    and cut, a reduce-scatter) and ``"slice"`` where every rank does the
    same work on it (the gradient is whole and equal on every rank: this
    rank's slice, nothing summed).  ``reduce_scatter_model``'s backward
    all-gathers, ``sum_model``'s passes the gradient on (its output is the
    same on every rank and so is what every rank does with it),
    ``fork_model`` is the identity whose backward sums over ``model`` (a
    tensor equal on every rank that enters work split over the ranks), and
    ``first_rank_grad`` keeps the gradient on the first model rank only (a
    term equal on every rank whose gradient the others would count again).
    The backward passes count into the same counters as the forward.  The
    all-to-all and the broadcast from the last model rank are not on the
    training path: they refuse a tensor that needs a gradient."""
    mesh: object
    sum_bytes: int = 0
    sent_bytes: int = 0
    a2a_bytes: int = 0
    model_bytes: int = 0
    line_bytes: int = 0
    sum_s: float = 0.0
    shift_s: float = 0.0
    a2a_s: float = 0.0
    model_s: float = 0.0
    line_s: float = 0.0
    staging_s: float = 0.0
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COUNTERS, 0))

    def __post_init__(self):
        from repro_torch.launch.mesh import data_axes
        self.data = self.mesh.axis(*data_axes(self.mesh))
        self.model = self.mesh.axis("model")
        self._pinned: dict = {}

    def _count(self, counter: str, nbytes: int) -> None:
        """``nbytes`` more in ``<counter>_bytes``, one more call."""
        setattr(self, f"{counter}_bytes",
                getattr(self, f"{counter}_bytes") + nbytes)
        self.calls[counter] += 1

    def _staged(self, device: torch.device) -> bool:
        return self.mesh.backend == "gloo" and device.type == "cuda"

    def _host(self, x: Tensor, slot: "str | None" = None) -> Tensor:
        """``x`` copied to pinned host memory; with ``slot`` into a buffer
        kept for that slot and shape (a bucket's, reused bucket after
        bucket: pinning a buffer costs more than the copy)."""
        t0 = time.perf_counter()
        key = (slot, tuple(x.shape), x.dtype)
        host = self._pinned.get(key) if slot is not None else None
        if host is None:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            if slot is not None:
                self._pinned[key] = host
        with trace.marked("transport-staging"):
            host.copy_(x)
        self.staging_s += time.perf_counter() - t0
        return host

    def _parts(self, send: Tensor) -> list:
        """Receive buffers for the data ranks' parts of a bucket: pinned
        and kept per shape when staged, else new."""
        n = self.data.world_size
        if send.device.type != "cpu" or not send.is_pinned():
            return [torch.empty_like(send) for _ in range(n)]
        key = ("parts", tuple(send.shape), send.dtype)
        if key not in self._pinned:
            self._pinned[key] = [torch.empty_like(send).pin_memory()
                                 for _ in range(n)]
        return self._pinned[key]

    def _device(self, x: Tensor, device: torch.device) -> Tensor:
        t0 = time.perf_counter()
        out = x.to(device)
        self.staging_s += time.perf_counter() - t0
        return out

    def sum_data(self, tensors: Sequence[Tensor],
                 replicas: bool = False) -> Sequence[Tensor]:
        """Σ over the data ranks of every tensor, in place (each keeps its
        dtype; the sum runs in f32); returns ``tensors``.

        The tensors' elements are cut into f32 buckets of at most
        ``BUCKET_BYTES``; each bucket is one all-gather and a sum of the
        parts in rank order (``fold``).  Every rank adds the same parts in
        the same order, so every rank holds the same bits — a line search
        that reads a sum on one rank must decide as on every other, and
        neither backend's ``all_reduce`` promises equal bits on every rank
        — while no rank holds more than one bucket's parts at a time.
        With ``replicas`` (the model ranks hold copies: data-parallel
        training) each bucket's sum is then broadcast from the first rank
        of this rank's model line, so copies computed apart stay equal."""
        import torch.distributed as dist
        line = self.model if replicas else None
        if self.data.world_size == 1 and (line is None
                                          or line.world_size == 1):
            return tensors
        t0 = time.perf_counter()
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("sum_data sums contiguous tensors in place")
        dev = tensors[0].device
        stage = self._staged(dev)
        cap = BUCKET_BYTES // 4
        buckets, cur, used = [], [], 0
        for i, t in enumerate(tensors):
            a = 0
            while a < t.numel():
                b = min(t.numel(), a + cap - used)
                cur.append((i, a, b))
                used += b - a
                a = b
                if used == cap:
                    buckets.append(cur)
                    cur, used = [], 0
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            flat = torch.cat([tensors[i].detach().reshape(-1)[a:b].float()
                              for i, a, b in bucket])
            self._count("sum", flat.numel() * 4)
            if self.data.world_size > 1:
                send = self._host(flat, "send") if stage else flat
                parts = self._parts(send)
                dist.all_gather(parts, send, group=self.data.group)
                if stage:
                    parts = [self._device(p, dev) for p in parts]
                flat = fold(parts)
            if line is not None and line.world_size > 1:
                buf = self._host(flat, "send") if stage else flat
                dist.broadcast(buf, src=line.ranks[0], group=line.group)
                flat = self._device(buf, dev) if stage else buf
            off = 0
            for i, a, b in bucket:
                tensors[i].reshape(-1)[a:b].copy_(flat[off:off + b - a])
                off += b - a
        self.sum_s += time.perf_counter() - t0
        return tensors

    def shift(self, tag: int, to_prev=None, to_next=None, from_prev=None,
              from_next=None):
        """One round of messages along ``model``: ``to_prev`` / ``to_next``
        (lists of tensors, or None) go to the previous / next model rank,
        and ``(from_prev, from_next)`` come back, each a list of tensors
        of the given ``[(shape, dtype), …]`` on this rank's device (None
        where none was asked for).  Both ends of a message name the same
        ``tag`` (one per purpose; messages of one purpose between two
        ranks arrive in the order sent): one ``batch_isend_irecv``."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        m, ranks = self.model.rank, self.model.ranks
        dev = self.mesh.device
        stage = self._staged(dev)
        ops, recvs = [], []
        for payload, peer, direction in ((to_prev, m - 1, 1),
                                         (to_next, m + 1, 0)):
            if payload is None:
                continue
            buf = _pack(payload)
            if stage:
                buf = self._host(buf)
            self._count("sent", buf.numel())
            ops.append(dist.P2POp(dist.isend, buf, ranks[peer],
                                  tag=2 * tag + direction))
        for like, peer, direction in ((from_prev, m - 1, 0),
                                      (from_next, m + 1, 1)):
            if like is None:
                recvs.append(None)
                continue
            n = sum(math.prod(s) * torch.empty((), dtype=d).element_size()
                    for s, d in like)
            buf = torch.empty((n,), dtype=torch.uint8, pin_memory=stage,
                              device="cpu" if stage else dev)
            ops.append(dist.P2POp(dist.irecv, buf, ranks[peer],
                                  tag=2 * tag + direction))
            recvs.append((buf, like))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = []
        for r in recvs:
            if r is None:
                out.append(None)
                continue
            buf, like = r
            out.append(_unpack(self._device(buf, dev) if stage else buf,
                               like))
        self.shift_s += time.perf_counter() - t0
        return tuple(out)

    # -- collectives along an axis (the tensor-parallel layers) ----------

    def _pinned_buf(self, key, like: Tensor) -> Tensor:
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _line_parts(self, x: Tensor, line) -> list:
        """Every rank of ``line``'s ``x`` (one shape and dtype on all), in
        rank order, on ``x``'s device."""
        import torch.distributed as dist
        n = line.world_size
        if n == 1:
            return [x]
        t0 = time.perf_counter()
        dev = x.device
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        if self._staged(dev):
            send = self._host(flat, "line-send")
            parts = [self._pinned_buf(("line-part", i, flat.numel()), flat)
                     for i in range(n)]
            dist.all_gather(parts, send, group=line.group)
            parts = [self._device(p, dev) for p in parts]
        else:
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=line.group)
        if line.ranks == self.model.ranks:
            self._count("model", (n - 1) * flat.numel())
            self.model_s += time.perf_counter() - t0
        else:
            self._count("line", (n - 1) * flat.numel())
            self.line_s += time.perf_counter() - t0
        return [p.view(x.dtype).reshape(x.shape) for p in parts]

    def model_parts(self, x: Tensor) -> list:
        """The model ranks' ``x``, in rank order."""
        return self._line_parts(x, self.model)

    def _joined(self, x: Tensor, dim: int, line) -> Tensor:
        parts = self._line_parts(x, line)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def gather_line(self, x: Tensor, dim: int, line,
                    back: str = "scatter") -> Tensor:
        """The parts of ``x`` of ``line``'s ranks, joined along ``dim`` in
        rank order; its gradient by ``back`` (the class's note)."""
        if line.world_size == 1:
            return x
        if back not in ("scatter", "slice"):
            raise ValueError(f"back is 'scatter' or 'slice', not {back!r}")
        if not _needs_grad(x):
            return self._joined(x, dim, line)
        return _Gather.apply(x, self, dim, line, back)

    def gather_model(self, x: Tensor, dim: int,
                     back: str = "scatter") -> Tensor:
        """All-gather along ``model``: the model ranks' ``x`` joined along
        ``dim`` in rank order."""
        return self.gather_line(x, dim, self.model, back)

    def _sum(self, x: Tensor) -> Tensor:
        """Σ over the model ranks in f32, rank order, in pieces of at most
        ``BUCKET_BYTES`` a rank: no rank holds more than one piece's parts
        at a time (a large replicated gradient would otherwise stand nm
        times over)."""
        if self.model.world_size == 1:
            return x
        step = BUCKET_BYTES // x.element_size()
        if x.numel() <= step:
            parts = self._line_parts(x, self.model)
            return fold([p.float() for p in parts]).to(x.dtype)
        flat = x.contiguous().reshape(-1)
        out = torch.empty_like(flat)
        for a in range(0, flat.numel(), step):
            parts = self._line_parts(flat[a:a + step], self.model)
            out[a:a + step] = fold([p.float() for p in parts]).to(x.dtype)
            del parts
        return out.view(x.shape)

    def sum_model(self, x: Tensor) -> Tensor:
        """Σ over the model ranks of ``x``, in f32 and rank order (``fold``
        of the all-gathered parts), cast back: every rank forms the same
        bits.  Its backward passes the gradient on."""
        if self.model.world_size == 1:
            return x
        if not _needs_grad(x):
            return self._sum(x)
        return _Sum.apply(x, self)

    def fork_model(self, x: Tensor) -> Tensor:
        """``x`` itself; its backward sums the gradient over ``model``."""
        if self.model.world_size == 1 or not _needs_grad(x):
            return x
        return _Fork.apply(x, self)

    def first_rank_grad(self, x: Tensor) -> Tensor:
        """``x`` itself; its backward keeps the gradient on the first rank
        of the model line and gives the others zero."""
        if self.model.world_size == 1 or not _needs_grad(x):
            return x
        return _FirstRank.apply(x, self.model.rank == 0)

    def _exchange(self, x: Tensor, counted: str, line=None) -> Tensor:
        """``x`` (n, ...) over the model ranks (or ``line``'s): row i goes
        to rank i, and row i of the result came from rank i
        (``all_to_all_single``)."""
        import torch.distributed as dist
        line = self.model if line is None else line
        n = line.world_size
        if n == 1:
            return x
        t0 = time.perf_counter()
        dev = x.device
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        if self._staged(dev):
            send = self._host(flat, "a2a-send")
            recv = self._pinned_buf(("a2a-recv", flat.numel()), flat)
            dist.all_to_all_single(recv, send, group=line.group)
            out = self._device(recv, dev)
        else:
            out = torch.empty_like(flat)
            dist.all_to_all_single(out, flat, group=line.group)
        sent = flat.numel() * (n - 1) // n
        if counted == "a2a":
            self._count("a2a", sent)
            self.a2a_s += time.perf_counter() - t0
        elif counted == "line":
            self._count("line", sent)
            self.line_s += time.perf_counter() - t0
        else:
            self._count("model", sent)
            self.model_s += time.perf_counter() - t0
        return out.view(x.dtype).reshape(x.shape)

    def all_to_all_model(self, x: Tensor) -> Tensor:
        """The expert-parallel exchange: ``x`` (nm, ...), row j sent to
        model rank j; row i of the result is rank i's row for this rank."""
        _no_grad_path(x, "the all-to-all dispatch")
        return self._exchange(x, "a2a")

    def _reduce_scatter(self, x: Tensor, dim: int, line=None) -> Tensor:
        """This rank's chunk along ``dim`` of Σ over the ranks of ``line``
        (``model`` by default), summed in f32 in rank order."""
        line = self.model if line is None else line
        n = line.world_size
        if n == 1:
            return x
        chunks = torch.stack(torch.chunk(x, n, dim))
        parts = self._exchange(chunks, "model" if line.ranks
                               == self.model.ranks else "line", line)
        return fold([p.float() for p in parts.unbind(0)]).to(x.dtype)

    def reduce_scatter_model(self, x: Tensor, dim: int) -> Tensor:
        """This rank's 1/nm of Σ over the model ranks of ``x`` along
        ``dim``: each rank's chunk m goes to rank m (an all-to-all), and
        the received parts are summed in f32 in rank order and cast back.
        Its backward all-gathers the gradient pieces."""
        if self.model.world_size == 1:
            return x
        if not _needs_grad(x):
            return self._reduce_scatter(x, dim)
        return _ReduceScatter.apply(x, self, dim)

    def mean_world(self, x: Tensor) -> Tensor:
        """The mean of a scalar over every rank, summed in rank order."""
        parts = self._line_parts(x.float().reshape(1), self.world)
        return (fold(parts) / len(parts)).reshape(()).to(x.dtype)

    @property
    def world(self):
        """Every rank of the mesh as one line, in rank (row-major) order."""
        from repro_torch.launch.mesh import AxisGroup
        m = self.mesh
        return AxisGroup(m.rank, m.world_size, m.backend, m.device, m.group,
                         tuple(range(m.world_size)))

    def from_last_model_rank(self, x: Tensor) -> Tensor:
        """``x`` of the last rank of this rank's model line, on every rank
        of it (``dist.broadcast``; ``x`` gives the shape and dtype)."""
        _no_grad_path(x, "the broadcast from the last model rank")
        return self.broadcast_model(x, self.model.world_size - 1)

    def broadcast_model(self, x: Tensor, index: int = 0) -> Tensor:
        """``x`` of the ``index``-th rank of this rank's model line, on
        every rank of it (``dist.broadcast``); the sending rank counts
        ``(nm − 1)`` copies in ``model_bytes``."""
        import torch.distributed as dist
        line = self.model
        if line.world_size == 1:
            return x
        t0 = time.perf_counter()
        stage = self._staged(x.device)
        buf = self._host(x) if stage else x.detach().contiguous().clone()
        dist.broadcast(buf, src=line.ranks[index], group=line.group)
        if line.rank == index:
            self._count("model", (line.world_size - 1) * buf.numel()
                        * buf.element_size())
        out = self._device(buf, x.device) if stage else buf
        self.model_s += time.perf_counter() - t0
        return out


def _needs_grad(x: Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _no_grad_path(x: Tensor, what: str) -> None:
    if _needs_grad(x):
        raise NotImplementedError(
            f"{what} has no backward pass: the tensor-parallel training "
            f"step runs in the data-manual region, where it is gated off")


class _Gather(torch.autograd.Function):
    """All-gather along a line; backward by ``back``: ``"scatter"`` sums
    the ranks' gradients in rank order and keeps this rank's chunk,
    ``"slice"`` keeps this rank's chunk of its own gradient."""

    @staticmethod
    def forward(ctx, x, comm, dim, line, back):
        ctx.comm, ctx.dim, ctx.line, ctx.back = comm, dim, line, back
        ctx.size = x.shape[dim]
        return comm._joined(x, dim, line)

    @staticmethod
    def backward(ctx, g):
        comm, line, dim = ctx.comm, ctx.line, ctx.dim
        if ctx.back == "slice":
            got = g.narrow(dim, line.rank * ctx.size, ctx.size)
        else:
            got = comm._reduce_scatter(g.contiguous(), dim, line)
        return got.contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._joined(g, ctx.dim, ctx.comm.model), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm._sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Fork(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._sum(g.contiguous()), None


class _FirstRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def arrival_rounds(plan: NeighborExchange) -> np.ndarray:
    """(n_shards, r_pad) int32: index of the round that delivers
    each receive slot's payload; -1 for resident own lanes (available
    before any wire) and never-wired padding slots."""
    arr = np.full((plan.n_shards, plan.r_pad), -1, dtype=np.int32)
    limit = plan.r_pad * plan.n_pad
    for ri, rnd in enumerate(plan.rounds):
        for _, dst in rnd.pairs:
            rows = rnd.recv_slot[dst]
            slots = np.unique(rows[rows < limit] // plan.n_pad)
            arr[dst, slots] = ri
    return arr


def overlap_stats(plan: NeighborExchange, neighbor_mask: np.ndarray,
                  feature_dims: Sequence[int], itemsize: int = 4,
                  enabled: bool = False,
                  peak_flops: float = PEAK_FLOPS,
                  ici_bw: float = LINK_BW) -> dict:
    """Analytic exposed-vs-total wire time of the round schedule.

    Models the double-buffered overlap the staged exchange enables: while
    round r is on the wire, a shard can aggregate every ELL slot whose
    payload is already resident (own lanes before round 0, round r' < r
    arrivals after).  Per round, the exposed wire time is what the
    available aggregation work cannot hide:

        exposed_r = max(0, t_wire(r) − credit_r)

    with ``credit`` the pipelined budget of hideable compute (unspent
    credit carries forward; compute of slots arriving in the final round
    runs after the wire and hides nothing).  Wire time prices each
    round's per-pair payload over one link of ``ici_bw`` bytes/s; compute
    prices the row-exact block-aggregation FLOPs (2·rc_m·rc_src·ΣC per
    consumed ELL slot) at ``peak_flops`` — by default the H100 model of
    ``PEAK_FLOPS`` and ``LINK_BW`` (the reference prices its own device),
    so the metric is a deterministic property of the schedule, not a
    wall-clock sample.  The worst shard's exposure is reported (rounds
    advance at the slowest participant).

    ``overlap_efficiency`` = hidden / total wire time ∈ [0, 1];
    ``exposed_wire_bytes`` = exposed seconds × link bandwidth.
    """
    nbr = np.asarray(neighbor_mask, bool)
    m = nbr.shape[0]
    k = plan.lanes_per_shard
    rc = np.asarray(plan.row_counts, dtype=np.int64) if plan.row_counts \
        else np.full(m, plan.n_pad, dtype=np.int64)
    total_c = int(np.sum(list(feature_dims)))
    n_gathers = len(list(feature_dims))
    arr = arrival_rounds(plan)
    t_wire = [r.rows_pad * total_c * itemsize / ici_bw for r in plan.rounds]
    total = float(sum(t_wire))

    # per-shard hideable compute per arrival group (seconds, all gathers)
    worst_exposed = 0.0
    for s in range(plan.n_shards):
        slot_gid = plan.needed_ids[s]
        group_flops = np.zeros(plan.num_rounds + 1)
        for lane in range(s * k, (s + 1) * k):
            for slot, gid in enumerate(slot_gid):
                if not nbr[lane, gid]:
                    continue
                g = int(arr[s, slot]) + 1          # own lanes -> group 0
                group_flops[g] += 2.0 * int(rc[lane]) * int(rc[gid]) \
                    * total_c
        credit = group_flops[0] / peak_flops
        exposed = 0.0
        for ri, tw in enumerate(t_wire):
            hidden = min(tw, credit)
            exposed += tw - hidden
            credit += group_flops[ri + 1] / peak_flops - hidden
        worst_exposed = max(worst_exposed, exposed)

    eff = 1.0 - worst_exposed / total if total > 0 else 0.0
    # scheduled bytes of the priced plan — every pair of every round moves
    # its rows_pad rows; this is exactly exchange_bytes(plan)["wire_bytes"]
    # (the per-second totals above price per *round* over one link, so
    # they are not byte-convertible when a round carries several pairs)
    wire_rows = sum(len(r.pairs) * r.rows_pad for r in plan.rounds)
    return {
        "enabled": bool(enabled),
        "num_rounds": plan.num_rounds,
        "num_groups": plan.num_rounds + 1,
        "total_wire_s": total,
        "exposed_wire_s": worst_exposed,
        "hidden_wire_s": total - worst_exposed,
        "overlap_efficiency": eff,
        "total_wire_bytes": int(wire_rows * total_c * itemsize),
        "exposed_wire_bytes": int(worst_exposed * ici_bw),
        "num_gathers": n_gathers,
        "model": {"peak_flops": peak_flops, "ici_bw": ici_bw,
                  "itemsize": itemsize},
    }


def exchange_bytes(plan: NeighborExchange, feature_dims: Sequence[int],
                   itemsize: int = 4) -> dict:
    """Scheduled wire volume of the p2p transport per ADMM iteration.

    ``wire_bytes`` is what the rounds actually move: per round,
    every participating pair transmits the round's padded ``rows_pad``
    *node* rows (shards outside the round's partial permutation move
    nothing).  A whole-block plan wires ``n_pad`` rows per community; a
    row-exact plan only the true sizes.  ``p2p_needed_bytes`` counts only
    the true (round-padding-free) rows, so ``wire_bytes ==
    p2p_needed_bytes + padding_bytes`` exactly — the invariant
    ``verify_transport_bytes`` enforces against the mask-derived
    ``gather_bytes`` accounting.
    """
    wire_rows = sum(len(r.pairs) * r.rows_pad for r in plan.rounds)
    true_rows = sum(r.true_rows for r in plan.rounds)
    wire = sum(wire_rows * c * itemsize for c in feature_dims)
    needed = sum(true_rows * c * itemsize for c in feature_dims)
    return {"wire_bytes": wire, "p2p_needed_bytes": needed,
            "padding_bytes": wire - needed, "wire_rows": wire_rows,
            "true_rows": true_rows, "num_rounds": plan.num_rounds,
            "r_pad": plan.r_pad, "row_exact": plan.row_exact,
            "lanes_per_shard": plan.lanes_per_shard}


def verify_transport_bytes(stats: dict) -> dict:
    """Invariant check tying the p2p schedule to the mask-derived stats.

    Hard invariants (raise — true by construction, a violation means the
    schedule or accounting is broken): (a) the transport never moves more
    than the all-gather it replaces, (b) wire == true scheduled rows +
    round padding, (c) the true rows stay within the block-level
    ``needed_bytes`` the masks record (per-shard deduplication only
    shrinks them).

    ``wire_bytes <= needed_bytes`` *including* padding additionally holds
    whenever each shard hosts one community (k=1: every round row is a
    real row, zero padding) *and* the plan is whole-block — the benchmark
    sweeps and CI guards (benchmarks/check_bench.py) run in that regime
    and assert it strictly.  Row-exact plans can carry round padding even
    at k=1 (messages of different true sizes share a round), so there —
    as on multi-lane shards — padding overshoot is recorded as
    ``wire_within_needed`` rather than raised; the schedule is still
    correct, still bounded by the all-gather volume, and its *true* rows
    are strictly fewer than the whole-block plan's.
    """
    wire = stats["wire_bytes"]
    if wire > stats["full_bytes"]:
        raise ValueError(
            f"p2p transport moves more than all-gather: wire={wire} > "
            f"full={stats['full_bytes']}")
    if wire != stats["p2p_needed_bytes"] + stats["padding_bytes"]:
        raise ValueError(
            f"wire accounting inconsistent: {wire} != "
            f"{stats['p2p_needed_bytes']} + {stats['padding_bytes']}")
    if stats["p2p_needed_bytes"] > stats["needed_bytes"]:
        raise ValueError(
            f"scheduled rows exceed the mask-derived needed volume: "
            f"{stats['p2p_needed_bytes']} > {stats['needed_bytes']}")
    stats["wire_within_needed"] = wire <= stats["needed_bytes"]
    if stats.get("lanes_per_shard") == 1 and not stats.get("row_exact") \
            and not stats["wire_within_needed"]:
        raise ValueError(
            f"k=1 whole-block schedule has padding ({wire} > "
            f"{stats['needed_bytes']}) — impossible by construction, "
            f"accounting is broken")
    return stats

