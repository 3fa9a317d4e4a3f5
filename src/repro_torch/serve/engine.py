"""Low-latency community-sharded inference over a trained GCN.

The port of ``repro.serve.engine``.  ``CommunityServer`` serves final-layer
embeddings for single nodes out of a trained ``ParallelADMMTrainer`` model
(weights + community layout):

  * the node set lives on one packed Σ-bucket-rows plane
    (``CommunityLayout.device_layout(1)``), so community m's rows are a
    contiguous ``row_counts[m]``-row slice at ``local_offsets[m]``;
  * an **embedding cache** holds per-(community, layer) activation blocks;
    a request for node v whose ``(comm(v), L)`` block is resident is
    answered by one row gather out of that block — no aggregation;
  * a **halo cache** holds the cross-community halves
    Σ_{r∈N_m\\{m}} Ã_{m,r} Z_{l-1}[r] of each aggregation, so a miss whose
    inputs are clean recomputes only the *self* block product and the layer
    GEMM; only a cold or invalidated neighbourhood pays for the packed
    kernel's halo pass (``kernels.ops.community_halo_spmm``);
  * a feature update to node v dirties exactly the reader closure of v's
    community (``graph.read_closure``) — v's own community's cache lines
    plus the halo entries of communities that read it
    (``graph.halo_readers``); everything else stays served from cache.

Both caches are fixed-capacity LRU with optional Zipf-aware admission
(``serve.cache``); ``ServeConfig(cache_enabled=False)`` zeroes the
capacities, which makes every request recompute — the baseline — through
the *same* operations, so enabled vs disabled parity is bitwise.

On a CUDA device the halo pass runs the packed ELL kernel and the fused
cold path the fused kernel; on the CPU both run their plain versions.  The
remaining steps (row gather, row scatter, row slice, self + halo, the
layer GEMM and its activation) are plain tensor operations.  Cached blocks
never alias a tensor that is later written: scratch planes are fresh per
call, and ``update_features`` replaces the feature plane rather than
writing into it.  ``serve`` reads one result to the host per community
batch (the response) and nothing else.  ``hit_path_trace`` and
``halo_path_trace`` (the counterparts of the reference's
``hit_path_lowered`` / ``halo_path_lowered``) run the hit and halo paths
once on placeholder operands under the op-trace recorder, for
``repro_torch.analysis``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core import gcn, graph, messages
from repro_torch.kernels import community_spmm
from repro_torch.kernels import ops as kops
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.cache import LRUCache
from repro_torch.util.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (frozen, like TrainerConfig)."""

    embed_capacity: int = 16     # (community, layer) activation blocks
    halo_capacity: int = 64      # (community, layer) halo aggregates
    cache_enabled: bool = True   # False: capacity-0 caches (baseline)
    admission: str = "zipf"      # "zipf" | "lru"
    sketch_sample: int = 1024    # admission sketch aging period
    fused: bool = False          # cold-path agg→GEMM via the fused kernel
    max_batch: int = 1024        # per-community batch bound (ladder cap)

    def __post_init__(self):
        if self.admission not in ("zipf", "lru"):
            raise ValueError(f"unknown admission {self.admission!r}")


def _take_rows(block: Tensor, rows: Tensor) -> Tensor:
    """The hit path: the requested rows of one community block."""
    return block.index_select(0, rows)


def _halo_row(ell_row: Tensor, off_row: Tensor, mask_row: Tensor,
              self_row: Tensor, plane: Tensor, rc_arr: Tensor,
              nc_row: Tensor, rc: int) -> Tensor:
    out = kops.community_halo_spmm(ell_row, off_row, mask_row, self_row,
                                   plane, rc_arr, nc_row)
    return out[0, :rc]


def _fused_row(ell_row: Tensor, off_row: Tensor, mask_row: Tensor,
               plane: Tensor, w: Tensor, rc_arr: Tensor, nc_row: Tensor,
               rc: int, act: str) -> Tensor:
    out = kops.community_spmm_ell_fused(ell_row, off_row, mask_row, plane, w,
                                        rc_arr, nc_row)
    return gcn.activation_fn(act)(out[0, :rc])


class CommunityServer:
    """Cached community-block inference over a trained model.

    ``device=None`` means ``cuda`` (RuntimeError without one); tests pass
    ``device="cpu"``."""

    def __init__(self, cfg: gcn.GCNConfig, layout: graph.CommunityLayout,
                 weights: Sequence, features: np.ndarray,
                 config: ServeConfig | None = None,
                 device: "str | torch.device | None" = None):
        self.device = device = resolve_device(device)
        self.cfg = cfg
        self.layout = layout
        self.config = config or ServeConfig()

        def put(x, dtype):
            """A device copy of a host array (never a view of it)."""
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        self.weights = [w.detach().to(device, torch.float32)
                        if isinstance(w, torch.Tensor)
                        else put(w, torch.float32) for w in weights]
        if len(self.weights) != cfg.num_layers:
            raise ValueError(f"{len(self.weights)} weight matrices for a "
                             f"{cfg.num_layers}-layer model")

        m = layout.num_parts
        csr = layout.compress()
        self.dl = dl = layout.device_layout(1)   # one resident plane
        rows, nbr = csr.ell_row_counts()
        self.row_counts = np.asarray(rows, np.int32)              # (M,)
        offsets = messages.plane_read_offsets(
            csr.ell_indices, csr.ell_mask, dl.local_offsets)
        self_mask = messages.self_slot_mask(csr.ell_indices, csr.ell_mask)
        community_spmm.check_plane_offsets(offsets, csr.ell_mask, nbr,
                                           dl.plane_rows)
        # per-community kernel operands: (1, max_deg, ...) rows of one
        # device copy of each table (leading-dim slices, contiguous views)
        blocks = put(csr.ell_blocks, torch.float32)
        off_t = put(offsets, torch.int32)
        mask_t = put(csr.ell_mask, torch.float32)
        self_t = put(self_mask, torch.float32)
        nc_t = put(nbr, torch.int32)
        rc_t = put(self.row_counts, torch.int32)
        self._ell_row = [blocks[i:i + 1] for i in range(m)]
        self._off_row = [off_t[i:i + 1] for i in range(m)]
        self._mask_row = [mask_t[i:i + 1] for i in range(m)]
        self._self_row = [self_t[i:i + 1] for i in range(m)]
        self._nc_row = [nc_t[i:i + 1] for i in range(m)]
        self._rc_arr = [rc_t[i:i + 1] for i in range(m)]
        ab = layout.a_blocks
        self._a_self = [put(ab[i, i, :self.row_counts[i], :self.row_counts[i]],
                            torch.float32) for i in range(m)]

        # dependency tables (incremental invalidation)
        self.neighbor_mask = np.asarray(layout.neighbor_mask, bool)
        self.readers = graph.halo_readers(self.neighbor_mask)
        self.neighbors = [np.flatnonzero(self.neighbor_mask[i]).astype(
            np.int32) for i in range(m)]

        # node id -> (community, block-local row, plane row)
        perm = np.asarray(layout.perm)
        n_nodes = int((perm >= 0).sum())
        node_comm = np.zeros(n_nodes, np.int32)
        node_row = np.zeros(n_nodes, np.int32)
        for slot, node in enumerate(perm):
            if node >= 0:
                node_comm[node] = slot // layout.n_pad
                node_row[node] = slot % layout.n_pad
        self.node_comm, self.node_row = node_comm, node_row
        self._node_plane_row = (
            np.asarray(dl.local_offsets)[node_comm] + node_row).astype(
            np.int32)
        self.batcher = RequestBatcher(node_comm, node_row,
                                      max_batch=self.config.max_batch)

        # layer-0 plane: packed features — resident, always fresh
        z0 = dl.pack_state(layout.pack(np.asarray(features, np.float32)))
        self.z0_plane = put(z0, torch.float32)

        c = self.config
        ecap = c.embed_capacity if c.cache_enabled else 0
        hcap = c.halo_capacity if c.cache_enabled else 0
        self.embed_cache = LRUCache(ecap, admission=c.admission,
                                    sample=c.sketch_sample)
        self.halo_cache = LRUCache(hcap, admission=c.admission,
                                   sample=c.sketch_sample)
        self.request_hits = 0
        self.request_total = 0
        self.block_computes = 0
        self.halo_computes = 0

    @classmethod
    def from_trainer(cls, trainer, config: ServeConfig | None = None
                     ) -> "CommunityServer":
        """Build over a trained ``ParallelADMMTrainer``'s weights/layout,
        on the trainer's device."""
        return cls(trainer.cfg, trainer.layout,
                   trainer.state.weights, trainer.graph.features,
                   config=config, device=trainer.device)

    # --- block computation ------------------------------------------------

    def _block0(self, m: int) -> Tensor:
        start = int(self.dl.local_offsets[m])
        return self.z0_plane[start:start + int(self.row_counts[m])]

    def _block(self, m: int, layer: int) -> Tensor:
        """(row_counts[m], C_layer) activation block, cached."""
        if layer == 0:
            return self._block0(m)
        key = (m, layer)
        val = self.embed_cache.get(key)
        if val is not None:
            return val
        val = self._compute_block(m, layer)
        self.embed_cache.put(key, val)
        return val

    def _neighbor_plane(self, m: int, layer: int, with_self: bool) -> Tensor:
        """Copy the (clean) layer blocks community m reads onto a fresh
        scratch plane for the packed kernel.  Recursion bottoms out at the
        always-fresh layer-0 feature plane."""
        if layer == 0 and with_self:
            return self.z0_plane
        c = self.cfg.layer_dims[layer]
        plane = torch.zeros((self.dl.plane_rows, c), dtype=torch.float32,
                            device=self.device)
        for r in self.neighbors[m]:
            if not with_self and int(r) == m:
                continue
            blk = self._block(int(r), layer)
            start = int(self.dl.local_offsets[int(r)])
            plane[start:start + blk.shape[0]] = blk
        return plane

    def _compute_halo(self, m: int, layer: int) -> Tensor:
        """Σ_{r∈N_m\\{m}} Ã_{m,r} Z_{layer-1}[r] via the packed kernel."""
        self.halo_computes += 1
        plane = self._neighbor_plane(m, layer - 1, with_self=False)
        return _halo_row(self._ell_row[m], self._off_row[m],
                         self._mask_row[m], self._self_row[m], plane,
                         self._rc_arr[m], self._nc_row[m],
                         int(self.row_counts[m]))

    def _compute_block(self, m: int, layer: int) -> Tensor:
        self.block_computes += 1
        act = self.cfg.activation if layer < self.cfg.num_layers \
            else "identity"
        key = (m, layer)
        halo = self.halo_cache.get(key)
        if halo is None and self.config.fused:
            # cold path through the fused aggregation→GEMM kernel: one
            # pass, no halo intermediate — and therefore no halo entry to
            # admit (the fused trade: faster cold recompute, fuller
            # recompute after the next invalidation)
            plane = self._neighbor_plane(m, layer - 1, with_self=True)
            return _fused_row(self._ell_row[m], self._off_row[m],
                              self._mask_row[m], plane,
                              self.weights[layer - 1], self._rc_arr[m],
                              self._nc_row[m], int(self.row_counts[m]), act)
        if halo is None:
            halo = self._compute_halo(m, layer)
            self.halo_cache.put(key, halo)
        z_prev = self._block(m, layer - 1)
        agg = self._a_self[m] @ z_prev + halo
        return gcn.activation_fn(act)(agg @ self.weights[layer - 1])

    # --- serving ----------------------------------------------------------

    def _rows(self, rows: np.ndarray) -> Tensor:
        """Row indices on the device without a host sync: a pinned staging
        copy, sent asynchronously."""
        t = torch.from_numpy(rows)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def serve(self, node_ids: np.ndarray) -> np.ndarray:
        """Final-layer embeddings for ``node_ids``, in request order."""
        ids = np.asarray(node_ids)
        n_l = self.cfg.num_layers
        out = np.zeros((len(ids), self.cfg.layer_dims[-1]), np.float32)
        for b in self.batcher.coalesce(ids):
            hit = (b.comm, n_l) in self.embed_cache
            block = self._block(b.comm, n_l)
            self.request_total += b.count
            if hit:
                self.request_hits += b.count
            vals = _take_rows(block, self._rows(b.rows))
            out[b.positions] = vals.cpu().numpy()[:b.count]
        return out

    # --- incremental invalidation ----------------------------------------

    def update_features(self, node_ids: np.ndarray, feats: np.ndarray
                        ) -> dict:
        """Apply a feature update and invalidate exactly its read closure.

        Returns the dropped cache keys and the per-hop dirty community
        sets — the tests assert these match the dependency tables'
        prediction, and that everything *not* listed keeps serving from
        cache."""
        ids = np.asarray(node_ids, np.int64)
        feats = np.asarray(feats, np.float32)
        if feats.shape != (len(ids), self.cfg.layer_dims[0]):
            raise ValueError(f"feats shape {feats.shape} != "
                             f"({len(ids)}, {self.cfg.layer_dims[0]})")
        rows = torch.as_tensor(self._node_plane_row[ids], dtype=torch.long,
                               device=self.device)
        # out of place, as the reference's .at[].set: a new plane
        self.z0_plane = self.z0_plane.index_put(
            (rows,), torch.as_tensor(feats, device=self.device))

        n_l = self.cfg.num_layers
        seeds = np.unique(self.node_comm[ids])
        closure = graph.read_closure(self.neighbor_mask, seeds, hops=n_l)
        nbr_cross = self.neighbor_mask & ~np.eye(
            self.neighbor_mask.shape[0], dtype=bool)
        dropped_embed, dropped_halo = [], []
        for layer in range(1, n_l + 1):
            for m in closure[layer]:
                if self.embed_cache.invalidate((int(m), layer)):
                    dropped_embed.append((int(m), layer))
            # halo(m, layer) reads Z_{layer-1} of N_m \ {m}
            halo_dirty = np.flatnonzero(
                nbr_cross[:, closure[layer - 1]].any(axis=1))
            for m in halo_dirty:
                if self.halo_cache.invalidate((int(m), layer)):
                    dropped_halo.append((int(m), layer))
        return {"dirty": [c.tolist() for c in closure],
                "embed": dropped_embed, "halo": dropped_halo}

    # --- analysis ---------------------------------------------------------

    def hit_path_trace(self, bucket: int = 64) -> "trace.Trace":
        """The steady-state hit path, recorded on placeholders: one
        community block in, ``bucket`` requested rows out."""
        rc = int(self.row_counts.max())
        block = torch.zeros((rc, self.cfg.layer_dims[-1]),
                            dtype=torch.float32, device=self.device)
        rows = torch.zeros((int(bucket),), dtype=torch.int32,
                           device=self.device)
        with trace.record() as tape:
            _take_rows(block, rows)
        return tape

    def halo_path_trace(self, layer: int = 1) -> "trace.Trace":
        """The miss path's halo pass of community 0 at ``layer``, recorded
        on placeholders: zero tables (every slot masked) and a zero plane
        of the resident plane's rows (the plane is legitimately
        Σ-bucket-rows tall here; the rule checked is no collective)."""
        c = self.cfg.layer_dims[layer - 1]

        def zeros(like, dtype):
            return torch.zeros(like.shape, dtype=dtype, device=self.device)

        ops = (zeros(self._ell_row[0], torch.float32),
               zeros(self._off_row[0], torch.int32),
               zeros(self._mask_row[0], torch.float32),
               zeros(self._self_row[0], torch.float32),
               torch.zeros((self.dl.plane_rows, c), dtype=torch.float32,
                           device=self.device),
               self._rc_arr[0].clone(),
               zeros(self._nc_row[0], torch.int32))
        with trace.record() as tape:
            _halo_row(*ops, int(self.row_counts[0]))
        return tape

    # --- introspection ----------------------------------------------------

    def stats(self) -> dict:
        return {
            "requests": {
                "total": self.request_total,
                "hits": self.request_hits,
                "hit_rate": round(
                    self.request_hits / max(self.request_total, 1), 4),
            },
            "block_computes": self.block_computes,
            "halo_computes": self.halo_computes,
            "embed_cache": self.embed_cache.stats.as_dict(),
            "halo_cache": self.halo_cache.stats.as_dict(),
        }

    def reset_stats(self) -> None:
        self.request_hits = self.request_total = 0
        self.block_computes = self.halo_computes = 0
        self.embed_cache.stats.reset()
        self.halo_cache.stats.reset()
