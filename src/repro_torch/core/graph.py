"""Graph substrate for the community-based ADMM GCN trainer.

Host-side (numpy) utilities: normalized adjacency construction, balanced
community partitioning (METIS stand-in, same contract), community-blocked
layouts used by the parallel trainer and the ELL aggregation kernel.

The port's own copy of ``repro.core.graph``: numpy only, and every array it
builds must equal the JAX package's exactly (tests/test_torch_graph.py).
Docstrings keep the reference's wording where they describe the TPU
layout rules (8-row multiples) that the shared layout still follows.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected, unweighted graph with node features and labels."""

    edges: Array          # (E, 2) int32, undirected (each edge stored once)
    features: Array       # (N, C0) float32
    labels: Array         # (N,) int32
    train_mask: Array     # (N,) bool
    test_mask: Array      # (N,) bool
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


def adjacency_lists(num_nodes: int, edges: Array) -> list[list[int]]:
    adj: list[list[int]] = [[] for _ in range(num_nodes)]
    for u, v in edges:
        if u != v:
            adj[int(u)].append(int(v))
            adj[int(v)].append(int(u))
    return adj


def normalized_adjacency(num_nodes: int, edges: Array) -> Array:
    """Dense Ã = (D+I)^{-1/2} (A+I) (D+I)^{-1/2} (paper, Problem 1)."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    u, v = edges[:, 0], edges[:, 1]
    a[u, v] = 1.0
    a[v, u] = 1.0
    np.fill_diagonal(a, 0.0)
    deg = a.sum(axis=1)
    a = a + np.eye(num_nodes, dtype=np.float32)
    d_inv_sqrt = 1.0 / np.sqrt(deg + 1.0)
    return (a * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


def partition_graph(num_nodes: int, edges: Array, num_parts: int,
                    seed: int = 0, refine_iters: int = 4,
                    method: str = "bfs_kl") -> Array:
    """Balanced edge-cut-minimizing partition.  Returns (N,) int32 ids.

    Two methods share the contract (every node assigned exactly once,
    part sizes ≤ ceil(N / num_parts), deterministic for a fixed seed):

      * ``"bfs_kl"`` (default, the original METIS stand-in): BFS-grown
        balanced seeds followed by Kernighan-Lin-style boundary refinement
        under a hard balance cap.  Kept as the oracle/fallback — its
        partitions are golden-checksummed in tests.
      * ``"multilevel"`` (sharding.multilevel): heavy-edge-matching
        coarsening → initial partition of the coarse graph → uncoarsen
        with boundary KL refinement at every level, the METIS scheme.
        Strictly lower edge cuts on power-law community graphs — the cut
        is the p2p wire volume, see BENCH_speedup.json `m32_partition`.
    """
    if method == "multilevel":
        from repro_torch.sharding.multilevel import multilevel_partition
        return multilevel_partition(num_nodes, edges, num_parts, seed=seed,
                                    refine_iters=refine_iters)
    if method != "bfs_kl":
        raise ValueError(f"unknown partition method {method!r}; "
                         f"expected 'bfs_kl' or 'multilevel'")
    rng = np.random.default_rng(seed)
    adj = adjacency_lists(num_nodes, edges)
    cap = int(np.ceil(num_nodes / num_parts))
    part = np.full(num_nodes, -1, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)

    # BFS-grow each partition from a fresh unassigned seed.
    order = rng.permutation(num_nodes)
    cursor = 0
    for p in range(num_parts):
        # find an unassigned seed
        while cursor < num_nodes and part[order[cursor]] >= 0:
            cursor += 1
        if cursor >= num_nodes:
            break
        # deque + enqueue-time seen marking: O(N + E) per part.  A node is
        # processed at its *earliest* enqueue position either way, so the
        # assignment order (and hence the partition for a fixed seed) is
        # identical to the old list.pop(0)/re-enqueue implementation, which
        # was O(N·frontier) and enqueued each neighbour once per discovery.
        seed_node = int(order[cursor])
        frontier = collections.deque([seed_node])
        seen = {seed_node}
        while frontier and sizes[p] < cap:
            node = frontier.popleft()
            part[node] = p
            sizes[p] += 1
            for n in adj[node]:
                if part[n] < 0 and n not in seen:
                    seen.add(n)
                    frontier.append(n)
    # Any stragglers go to the least-loaded part.
    for node in np.flatnonzero(part < 0):
        p = int(np.argmin(sizes))
        part[node] = p
        sizes[p] += 1

    # KL-style refinement: move boundary nodes if it reduces the cut and
    # keeps balance.
    for _ in range(refine_iters):
        moved = 0
        for node in rng.permutation(num_nodes):
            if not adj[node]:
                continue
            counts = np.bincount([part[n] for n in adj[node]],
                                 minlength=num_parts)
            best = int(np.argmax(counts))
            cur = int(part[node])
            if best != cur and counts[best] > counts[cur] and \
                    sizes[best] < cap and sizes[cur] > 1:
                part[node] = best
                sizes[cur] -= 1
                sizes[best] += 1
                moved += 1
        if moved == 0:
            break
    return part


def edge_cut(edges: Array, part: Array) -> int:
    return int(np.sum(part[edges[:, 0]] != part[edges[:, 1]]))


# ---------------------------------------------------------------------------
# size-aware (ragged) padding: bucket scheme
# ---------------------------------------------------------------------------

def pad_ladder(limit: int) -> list[int]:
    """The power-of-two-ish pad bucket boundaries up to ``limit``.

    All values are multiples of 8 (TPU sublane) and the ladder is geometric
    — {8, 16, 24, 32, 48, 64, 96, 128, 192, 256, ...}: ratio 2 on the
    single smallest step (8→16, the sublane floor) and ≤ 1.5 from 16 up —
    so bucketed padding wastes at most ~44% of a tiny community's rows
    (size 9 → bucket 16) and ~33% beyond the first step, where the
    global-max pad wastes up to ``n_pad / size``.
    """
    vals = {8}
    k = 16
    while k <= max(int(limit), 8) * 2:
        vals.add(k)
        vals.add(3 * k // 2)
        k *= 2
    return sorted(vals)


def bucket_pad_sizes(sizes: Array, n_pad: int) -> Array:
    """Per-community padded row counts under the bucket scheme.

    Each community pads to the smallest ladder bucket ≥ its size, capped at
    the layout's physical ``n_pad`` stride (communities in the top bucket
    keep the global pad).  Empty communities pad to zero rows.
    """
    ladder = pad_ladder(n_pad)
    out = np.zeros(len(sizes), dtype=np.int32)
    for i, s in enumerate(np.asarray(sizes)):
        if s <= 0:
            continue
        b = next((v for v in ladder if v >= s), ladder[-1])
        out[i] = min(int(b), int(n_pad))
    return out


def partition_quality(num_nodes: int, edges: Array, part: Array,
                      num_parts: int | None = None) -> dict:
    """Quality metrics a partition method is judged on (host-side, cheap).

    ``edge_cut`` is exactly the inter-community block volume a p2p
    transport wires; ``max_deg`` the ELL fan-in of the block layout it
    induces (community graph row degree incl. the self block — identical to
    ``BlockCSR.max_deg`` since Ã blocks are nonzero iff an edge crosses the
    community pair); ``balance`` the heaviest part over the strict cap
    ``ceil(N / M)`` (≤ 1.0 means the hard contract cap holds).
    """
    part = np.asarray(part)
    used = int(part.max()) + 1
    # honour the requested part count (empty trailing parts still count
    # toward the cap), but never index below what the labels actually use
    m = used if num_parts is None else max(int(num_parts), used)
    sizes = np.bincount(part, minlength=m)
    cap = int(np.ceil(num_nodes / m))
    nbr = np.zeros((m, m), dtype=bool)
    pu, pv = part[edges[:, 0]], part[edges[:, 1]]
    nbr[pu, pv] = True
    nbr[pv, pu] = True
    np.fill_diagonal(nbr, True)
    cut = edge_cut(edges, part)
    # padding the layout will pay for this partition's size skew: the global
    # scheme pads every community to max(sizes) (8-aligned), the bucket
    # scheme to its own power-of-two-ish bucket (bucket_pad_sizes)
    n_pad = -(-int(sizes.max()) // 8) * 8
    bucketed = bucket_pad_sizes(sizes, n_pad)
    return {
        "num_parts": m,
        "edge_cut": cut,
        "cut_frac": cut / max(int(edges.shape[0]), 1),
        "balance": float(sizes.max()) / cap,
        "min_size": int(sizes.min()),
        "max_size": int(sizes.max()),
        "max_deg": int(nbr.sum(axis=1).max()),
        "nnz_blocks": int(nbr.sum()),
        "n_pad": n_pad,
        "pad_rows_global": int(m * n_pad - sizes.sum()),
        "pad_rows_bucketed": int(bucketed.sum() - sizes.sum()),
    }


def shard_neighbor_graph(neighbor_mask: Array, n_shards: int
                         ) -> tuple[list[Array], Array]:
    """Lift the community topology to the mesh-shard level.

    With communities laid out community-major (``BlockCSR.shard_slice``),
    shard ``s`` hosts lanes ``[s·k, (s+1)·k)`` and its subproblems read the
    payload rows ``r ∈ ∪_{m∈lanes(s)} N_m ∪ {m}`` — the per-shard union of
    the ELL neighbour indices.  Returns:

      * ``needed``: per shard, the sorted global community ids it must hold
        (its own lanes always included — they are resident, not wired);
      * ``shard_adj``: (n_shards, n_shards) bool, ``[dst, src]`` True when
        ``dst`` needs at least one community hosted on ``src`` (diagonal
        excluded) — the shard-to-shard edge set a point-to-point transport
        schedules over.
    """
    nbr = np.asarray(neighbor_mask, bool)
    m = nbr.shape[0]
    if n_shards <= 0 or m % n_shards:
        raise ValueError(f"M={m} not divisible by n_shards={n_shards}")
    k = m // n_shards
    needed: list[Array] = []
    shard_adj = np.zeros((n_shards, n_shards), dtype=bool)
    for s in range(n_shards):
        rows = nbr[s * k:(s + 1) * k].any(axis=0)
        rows[s * k:(s + 1) * k] = True          # own lanes: resident
        ids = np.flatnonzero(rows).astype(np.int32)
        needed.append(ids)
        src_shards = np.unique(ids // k)
        shard_adj[s, src_shards] = True
        shard_adj[s, s] = False
    return needed, shard_adj


def halo_readers(neighbor_mask: Array) -> list[Array]:
    """Reverse community dependencies: who *reads* each community.

    ``readers[r]`` is the sorted set of communities m with
    ``neighbor_mask[m, r]`` — every m whose aggregation
    Σ_{r'∈N_m} Ã_{m,r'} Z_{r'} consumes community r's rows (m = r itself
    included via the diagonal).  This is exactly the per-community view of
    ``shard_neighbor_graph(neighbor_mask, M)`` transposed, and is what the
    serving engine's incremental invalidation walks: a feature update to a
    node of community r dirties Z_l of ``readers``-closure communities and
    the *halo* entries of ``readers[r] \\ {r}`` (serve.CommunityServer).
    """
    nbr = np.asarray(neighbor_mask, bool)
    return [np.flatnonzero(nbr[:, r]).astype(np.int32)
            for r in range(nbr.shape[0])]


def read_closure(neighbor_mask: Array, seeds: Array, hops: int) -> list[Array]:
    """Per-hop dirty sets of a community update.

    ``out[l]`` (l = 0..hops) is the sorted communities whose layer-l
    activations change when the layer-0 rows of ``seeds`` change:
    ``out[0] = seeds`` and ``out[l] = readers(out[l-1])`` — monotone
    non-shrinking because the diagonal makes every community its own
    reader.  Pure topology (no layout needed); the serving engine keys its
    cache invalidation off these sets and the tests check the dropped
    entries match them exactly.
    """
    nbr = np.asarray(neighbor_mask, bool)
    cur = np.zeros(nbr.shape[0], dtype=bool)
    cur[np.asarray(seeds, dtype=np.int64)] = True
    out = [np.flatnonzero(cur).astype(np.int32)]
    for _ in range(int(hops)):
        cur = nbr[:, cur].any(axis=1)
        out.append(np.flatnonzero(cur).astype(np.int32))
    return out


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """Block-compressed Ã: only the nnz present Ã_{m,r} blocks are stored.

    Memory is O(nnz · n_pad²) instead of the dense layout's O(M² · n_pad²);
    on a power-law community graph nnz grows ~linearly in M while M² does
    not.  Two views of the same blocks:

      * CSR-of-blocks (``indptr``/``indices``/``blocks``) — host-side
        compression, variable fan-in per row;
      * ELL (``ell_indices``/``ell_mask`` into ``ell_blocks``) — every row
        padded to the max fan-in ``max_deg``, fixed-shape and therefore the
        jit/vmap-friendly form the aggregation kernels consume.

    The layout is ragged-aware: ``sizes``/``row_counts`` carry the true and
    padded-per-bucket rows of every community (CommunityLayout), so block
    (m, r) holds real data only in its leading ``(sizes[m], sizes[r])``
    corner — the ELL kernel guards the pad rows out of the DMA+accumulate
    via the scalar-prefetched counts (``ell_row_counts``).
    """

    num_parts: int
    n_pad: int
    indptr: Array       # (M+1,) int32 — row m's blocks are [indptr[m], indptr[m+1])
    indices: Array      # (nnz,) int32 — source community of each stored block
    blocks: Array       # (nnz, n_pad, n_pad) float32
    ell_indices: Array  # (M, max_deg) int32 (rows padded with index 0)
    ell_mask: Array     # (M, max_deg) float32 (1 = real block, 0 = pad)
    ell_blocks: Array   # (M, max_deg, n_pad, n_pad) float32
    sizes: "Array | None" = None       # (M,) true rows per community
    row_counts: "Array | None" = None  # (M,) padded rows (bucket scheme)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.ell_indices.shape[1])

    @property
    def ell_nbytes(self) -> int:
        """Device-resident bytes of the ELL view (blocks + indices + mask)."""
        return (self.ell_blocks.nbytes + self.ell_indices.nbytes
                + self.ell_mask.nbytes)

    def shard_slice(self, shard: int, n_shards: int
                    ) -> tuple[Array, Array, Array]:
        """ELL rows for the communities hosted on mesh shard ``shard``.

        Community m's ELL row sits at index m (community-major order — the
        same order ``CommunityLayout.pack`` uses for Z), so sharding the
        leading axis with ``P('comm')`` places rows [s·k, (s+1)·k) on shard
        s; this helper extracts that exact slice host-side (benchmarks,
        per-shard byte accounting).  ``ell_indices`` stay *global* community
        ids — they index the gathered (M, n_pad, C) payload, not local rows.
        """
        if self.num_parts % n_shards:
            raise ValueError(f"M={self.num_parts} not divisible by "
                             f"n_shards={n_shards}")
        k = self.num_parts // n_shards
        sl = slice(shard * k, (shard + 1) * k)
        return self.ell_blocks[sl], self.ell_indices[sl], self.ell_mask[sl]

    def ell_row_counts(self) -> tuple[Array, Array]:
        """Per-lane and per-neighbour padded row counts for the ELL kernel.

        Returns ``(row_counts, nbr_counts)``: (M,) rows each output lane
        owns and (M, max_deg) rows each stored neighbour block contributes
        (0 on padding slots).  With no ragged metadata both default to the
        full ``n_pad`` — the global-pad behaviour.
        """
        m = self.num_parts
        if self.row_counts is None:
            rows = np.full(m, self.n_pad, dtype=np.int32)
        else:
            rows = np.asarray(self.row_counts, dtype=np.int32)
        nbr = rows[self.ell_indices] * (np.asarray(self.ell_mask) > 0)
        return rows, nbr.astype(np.int32)

    def to_dense(self) -> Array:
        """Reconstruct the dense (M, M, n_pad, n_pad) block tensor.

        Ragged layouts reconstruct identically: pad rows/cols of every
        stored block are zero by construction (asserted in tests), so the
        dense tensor is the same whether counts are tracked or not.
        """
        m, n = self.num_parts, self.n_pad
        out = np.zeros((m, m, n, n), dtype=np.float32)
        for row in range(m):
            lo, hi = int(self.indptr[row]), int(self.indptr[row + 1])
            for k in range(lo, hi):
                out[row, int(self.indices[k])] = self.blocks[k]
        return out

    def spmm(self, z_all: Array) -> Array:
        """Σ_{r∈N_m} Ã_{m,r} Z_r via the ELL view — O(nnz·n_pad²·C) FLOPs.

        z_all: (M, n_pad, C) -> (M, n_pad, C).  Host-side (numpy) twin of
        kernels.ops.community_spmm_ell — keep the two contractions in sync:
        like the kernel, pad rows beyond ``row_counts`` are masked out of
        the contraction (a numerical no-op — they are zero — that keeps
        this oracle's semantics identical to the guarded kernel).
        """
        rows, nbr_rows = self.ell_row_counts()
        lane = np.arange(self.n_pad)
        z_g = z_all[self.ell_indices]                # (M, max_deg, n_pad, C)
        z_g = z_g * self.ell_mask[..., None, None]
        z_g = z_g * (lane[None, None, :, None] < nbr_rows[..., None, None])
        out = np.einsum("mdip,mdpc->mic", self.ell_blocks, z_g)
        return out * (lane[None, :, None] < rows[:, None, None])


def compress_blocks(a_blocks: Array, neighbor_mask: Array,
                    sizes: Array | None = None,
                    row_counts: Array | None = None) -> BlockCSR:
    """Build the CSR-of-blocks + ELL views from a dense block tensor."""
    m, _, n_pad, _ = a_blocks.shape
    nbr = np.asarray(neighbor_mask, bool)
    indptr = np.zeros(m + 1, dtype=np.int32)
    indices, blocks = [], []
    for row in range(m):
        cols = np.flatnonzero(nbr[row])
        indptr[row + 1] = indptr[row] + len(cols)
        indices.extend(int(c) for c in cols)
        blocks.extend(a_blocks[row, c] for c in cols)
    indices = np.asarray(indices, dtype=np.int32)
    blocks = np.stack(blocks).astype(np.float32) if blocks else \
        np.zeros((0, n_pad, n_pad), np.float32)

    deg = np.diff(indptr)
    max_deg = int(deg.max()) if m else 0
    ell_indices = np.zeros((m, max_deg), dtype=np.int32)
    ell_mask = np.zeros((m, max_deg), dtype=np.float32)
    ell_blocks = np.zeros((m, max_deg, n_pad, n_pad), dtype=np.float32)
    for row in range(m):
        lo, hi = int(indptr[row]), int(indptr[row + 1])
        d = hi - lo
        ell_indices[row, :d] = indices[lo:hi]
        ell_mask[row, :d] = 1.0
        ell_blocks[row, :d] = blocks[lo:hi]
    return BlockCSR(num_parts=m, n_pad=n_pad, indptr=indptr, indices=indices,
                    blocks=blocks, ell_indices=ell_indices, ell_mask=ell_mask,
                    ell_blocks=ell_blocks, sizes=sizes, row_counts=row_counts)


@dataclasses.dataclass(frozen=True)
class PackedDeviceLayout:
    """Packed Σ-bucket-rows device layout for an ``n_shards`` mesh.

    The strided device layout keeps community m at rows
    ``[m·n_pad, (m+1)·n_pad)`` of an (M, n_pad, C) stack, so the single
    largest community prices every resident Z/U/z0/label tensor.  The
    packed layout instead gives shard s one flat ``(plane_rows, C)``
    plane in which its k lanes sit back to back at their *bucket* row
    counts: community m starts at ``local_offsets[m]`` and owns
    ``row_counts[m]`` rows.  ``plane_rows`` is the max over shards of
    Σ-bucket-rows (shard_map needs one static per-shard shape), so
    resident bytes track true community size instead of ``M·n_pad``.

    The index tables make the packed ↔ blocked conversion a single
    static ``jnp.take(..., mode="fill", fill_value=0)`` each way —
    out-of-range entries encode "pad row / unused plane row", and since
    every trainer tensor is exactly zero beyond ``row_counts`` (the
    zero-outside-counts contract), the round trip is lossless and the
    blocked view is bitwise-identical to the strided layout's shard.
    """

    n_shards: int
    lanes_per_shard: int
    n_pad: int
    plane_rows: int        # S: per-shard packed plane height (8-aligned)
    row_counts: Array      # (M,) effective bucket rows per community
    local_offsets: Array   # (M,) row offset of community m in its plane
    shard_rows: Array      # (n_shards,) true packed rows per shard
    unpack_rows: Array     # (n_shards, k·n_pad) plane row | S (pad -> fill)
    pack_rows: Array       # (n_shards, S) blocked flat row | k·n_pad (fill)

    @property
    def num_parts(self) -> int:
        return int(self.row_counts.shape[0])

    @property
    def total_rows(self) -> int:
        """Rows of the full packed state stack (n_shards · plane_rows)."""
        return self.n_shards * self.plane_rows

    @property
    def true_rows(self) -> int:
        """Σ bucket rows — the ideal (non-shard-max) packed height."""
        return int(self.row_counts.sum())

    def state_rows(self, strided: bool = False) -> int:
        """Leading-dim rows a state tensor holds under either layout."""
        if strided:
            return self.num_parts * self.n_pad
        return self.total_rows

    def global_unpack_rows(self) -> Array:
        """(M·n_pad,) indices into the (total_rows,) packed stack; pad
        rows map out of range (use ``mode='fill'``).

        Memoized: the table is static per layout and both the trainer
        metrics and the serving hot path look it up every call, so the
        Python build loop runs once.  Treat the returned array as
        read-only (every consumer does)."""
        cached = self.__dict__.get("_global_unpack_rows")
        if cached is not None:
            return cached
        m, n, k = self.num_parts, self.n_pad, self.lanes_per_shard
        out = np.full(m * n, self.total_rows, dtype=np.int32)
        for c in range(m):
            s, rc = c // k, int(self.row_counts[c])
            base = s * self.plane_rows + int(self.local_offsets[c])
            out[c * n: c * n + rc] = base + np.arange(rc)
        object.__setattr__(self, "_global_unpack_rows", out)
        return out

    def global_pack_rows(self) -> Array:
        """(total_rows,) indices into the (M·n_pad,) blocked stack;
        unused plane rows map out of range (use ``mode='fill'``).
        Memoized like ``global_unpack_rows`` — read-only result."""
        cached = self.__dict__.get("_global_pack_rows")
        if cached is not None:
            return cached
        m, n, k = self.num_parts, self.n_pad, self.lanes_per_shard
        out = np.full(self.total_rows, m * n, dtype=np.int32)
        for c in range(m):
            s, rc = c // k, int(self.row_counts[c])
            base = s * self.plane_rows + int(self.local_offsets[c])
            out[base: base + rc] = c * n + np.arange(rc)
        object.__setattr__(self, "_global_pack_rows", out)
        return out

    def pack_state(self, x: Array, fill: float = 0.0) -> Array:
        """Host-side (M, n_pad, ...) blocked -> (total_rows, ...) packed."""
        flat = np.asarray(x).reshape((self.num_parts * self.n_pad,)
                                     + x.shape[2:])
        idx = self.global_pack_rows()
        out = np.full((self.total_rows,) + flat.shape[1:], fill, flat.dtype)
        ok = idx < flat.shape[0]
        out[ok] = flat[idx[ok]]
        return out

    def unpack_state(self, x: Array, fill: float = 0.0) -> Array:
        """Host-side (total_rows, ...) packed -> (M, n_pad, ...) blocked."""
        x = np.asarray(x)
        idx = self.global_unpack_rows()
        out = np.full((self.num_parts * self.n_pad,) + x.shape[1:], fill,
                      x.dtype)
        ok = idx < x.shape[0]
        out[ok] = x[idx[ok]]
        return out.reshape((self.num_parts, self.n_pad) + x.shape[1:])


@dataclasses.dataclass(frozen=True)
class CommunityLayout:
    """Community-blocked layout of a graph (paper §2, Fig. 1).

    Nodes are permuted so community m occupies rows [m*n_pad, m*n_pad+n_m);
    the *physical* stride between communities is ``n_pad`` (the global max,
    8-aligned) so every packed tensor keeps a fixed (M, n_pad, ...) shape.
    ``a_blocks[m, r]`` is the dense Ã_{m,r} block; ``neighbor_mask[m, r]``
    marks r ∈ N_m ∪ {m} (nonzero blocks) — the paper's first-order
    communication topology.  When built with ``compressed=True``,
    ``block_csr`` additionally stores only the present blocks
    (CSR-of-blocks / ELL; O(nnz·n_pad²) memory).

    Ragged (size-aware) padding: ``row_counts[m]`` is the number of rows
    community m is *logically* padded to.  Under ``pad_mode="global"`` it is
    ``n_pad`` everywhere (the historic behaviour); under
    ``pad_mode="bucketed"`` each community pads only to its power-of-two-ish
    size bucket (``bucket_pad_sizes``), so pad FLOPs (ELL kernel row-count
    guards), pad wire bytes (row-exact NeighborExchange payloads) and the
    ragged ``blockify`` representation all track true community size instead
    of the single largest community.  Rows in [sizes[m], n_pad) are zero in
    every packed tensor either way — bucketing changes what is *processed*
    and *wired*, never the math.
    """

    num_parts: int
    n_pad: int
    perm: Array            # (N,) original index of packed slot (padded: -1)
    a_blocks: Array        # (M, M, n_pad, n_pad) float32
    node_mask: Array       # (M, n_pad) bool  (True = real node)
    neighbor_mask: Array   # (M, M) bool
    sizes: Array           # (M,) int
    block_csr: "BlockCSR | None" = None
    row_counts: "Array | None" = None   # (M,) int32 — logical pad per community
    pad_mode: str = "global"

    @property
    def nnz_blocks(self) -> int:
        return int(np.asarray(self.neighbor_mask).sum())

    @property
    def pad_rows(self) -> int:
        """Logical padding rows this layout carries (Σ row_counts − Σ sizes)."""
        return int(np.sum(self.eff_row_counts()) - np.sum(self.sizes))

    def eff_row_counts(self) -> Array:
        """(M,) effective per-community padded row counts (global fallback)."""
        if self.row_counts is None:
            return np.full(self.num_parts, self.n_pad, dtype=np.int32)
        return np.asarray(self.row_counts, dtype=np.int32)

    def row_offsets(self) -> Array:
        """(M+1,) ragged row offsets of the ``blockify`` representation."""
        return np.concatenate(
            [[0], np.cumsum(self.eff_row_counts())]).astype(np.int64)

    def compress(self) -> BlockCSR:
        """CSR-of-blocks view of ``a_blocks`` (cached when built with
        ``compressed=True``)."""
        if self.block_csr is not None:
            return self.block_csr
        return compress_blocks(self.a_blocks, self.neighbor_mask,
                               sizes=self.sizes, row_counts=self.row_counts)

    def blockify(self, x: Array, fill: float = 0.0) -> Array:
        """(N, ...) node array -> ragged (R, ...) community-blocked array.

        The ragged twin of ``pack``: community m occupies rows
        [row_offsets()[m], row_offsets()[m] + row_counts[m]) with its
        ``sizes[m]`` real rows first, padded to its *bucket* (not the global
        ``n_pad``), so R = Σ_m row_counts[m] ≤ M·n_pad — the resident-bytes
        win of size-aware padding, exact for any size distribution.
        """
        counts = self.eff_row_counts()
        offs = self.row_offsets()
        out = np.full((int(offs[-1]),) + x.shape[1:], fill, dtype=x.dtype)
        for m in range(self.num_parts):
            members = self.perm[m * self.n_pad:
                                m * self.n_pad + int(self.sizes[m])]
            assert int(self.sizes[m]) <= int(counts[m]), \
                f"community {m}: {self.sizes[m]} rows exceed its " \
                f"{counts[m]}-row bucket"
            out[offs[m]: offs[m] + int(self.sizes[m])] = x[members]
        return out

    def unblockify(self, x: Array) -> Array:
        """Ragged (R, ...) -> (N, ...) in original node order (inverse of
        ``blockify`` on the real rows; pad rows are discarded)."""
        offs = self.row_offsets()
        n = int((self.perm >= 0).sum())
        out = np.zeros((n,) + x.shape[1:], dtype=x.dtype)
        for m in range(self.num_parts):
            members = self.perm[m * self.n_pad:
                                m * self.n_pad + int(self.sizes[m])]
            out[members] = x[offs[m]: offs[m] + int(self.sizes[m])]
        return out

    def device_layout(self, n_shards: int) -> PackedDeviceLayout:
        """Packed Σ-bucket-rows device layout for an ``n_shards`` mesh.

        Shard s (lanes [s·k, (s+1)·k)) packs its communities back to back
        at their bucket row counts; the per-shard plane height is the max
        over shards (fixed shard_map shapes).  Under ``pad_mode="global"``
        every bucket is ``n_pad`` so packed degenerates to strided — the
        memory win needs bucketed counts and k > 1.
        """
        m, n = self.num_parts, self.n_pad
        if n_shards <= 0 or m % n_shards:
            raise ValueError(f"M={m} not divisible by n_shards={n_shards}")
        k = m // n_shards
        rc = self.eff_row_counts().astype(np.int32)
        shard_rows = rc.reshape(n_shards, k).sum(axis=1).astype(np.int32)
        plane = max(int(shard_rows.max()), 8)
        local = np.zeros(m, dtype=np.int32)
        for s in range(n_shards):
            local[s * k:(s + 1) * k] = np.concatenate(
                [[0], np.cumsum(rc[s * k:(s + 1) * k])[:-1]])
        unpack = np.full((n_shards, k * n), plane, dtype=np.int32)
        packr = np.full((n_shards, plane), k * n, dtype=np.int32)
        for c in range(m):
            s, i, cnt = c // k, c % k, int(rc[c])
            rows = np.arange(cnt)
            unpack[s, i * n: i * n + cnt] = int(local[c]) + rows
            packr[s, int(local[c]): int(local[c]) + cnt] = i * n + rows
        return PackedDeviceLayout(
            n_shards=n_shards, lanes_per_shard=k, n_pad=n,
            plane_rows=plane, row_counts=rc, local_offsets=local,
            shard_rows=shard_rows, unpack_rows=unpack, pack_rows=packr)

    def pack(self, x: Array, fill: float = 0.0) -> Array:
        """(N, ...) node array -> (M, n_pad, ...) community-blocked array."""
        out_shape = (self.num_parts * self.n_pad,) + x.shape[1:]
        out = np.full(out_shape, fill, dtype=x.dtype)
        valid = self.perm >= 0
        out[valid.nonzero()[0]] = x[self.perm[valid]]
        return out.reshape((self.num_parts, self.n_pad) + x.shape[1:])

    def unpack(self, x: Array) -> Array:
        """(M, n_pad, ...) -> (N, ...) in original node order."""
        flat = x.reshape((self.num_parts * self.n_pad,) + x.shape[2:])
        n = int((self.perm >= 0).sum())
        out = np.zeros((n,) + x.shape[2:], dtype=x.dtype)
        valid = self.perm >= 0
        out[self.perm[valid]] = flat[valid.nonzero()[0]]
        return out


def build_community_layout(num_nodes: int, edges: Array, part: Array,
                           pad_to: int | None = None,
                           compressed: bool = False,
                           pad_mode: str = "global",
                           num_parts: int | None = None) -> CommunityLayout:
    """``pad_mode``: "global" pads every community to the max size (the
    historic layout); "bucketed" additionally records per-community
    ``row_counts`` under the power-of-two-ish bucket scheme
    (``bucket_pad_sizes``) that the ragged consumers (ELL kernel guards,
    row-exact exchange, ``blockify``) key off.  ``num_parts`` forces the
    community count (trailing empty communities are otherwise dropped)."""
    if pad_mode not in ("global", "bucketed"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}; "
                         f"expected 'global' or 'bucketed'")
    used = int(part.max()) + 1 if len(part) else 1
    if num_parts is None:
        num_parts = used
    elif int(num_parts) < used:
        raise ValueError(f"num_parts={num_parts} below the {used} "
                         f"communities present in part — pass a partition "
                         f"that fits or raise num_parts")
    else:
        num_parts = int(num_parts)
    sizes = np.bincount(part, minlength=num_parts)
    n_pad = int(sizes.max()) if pad_to is None else int(pad_to)
    # round pad up to a multiple of 8 (TPU sublane) for kernel friendliness
    n_pad = -(-n_pad // 8) * 8
    row_counts = bucket_pad_sizes(sizes, n_pad) if pad_mode == "bucketed" \
        else None

    a_tilde = normalized_adjacency(num_nodes, edges)
    perm = np.full(num_parts * n_pad, -1, dtype=np.int64)
    slot_of = np.zeros(num_nodes, dtype=np.int64)
    for m in range(num_parts):
        members = np.flatnonzero(part == m)
        perm[m * n_pad: m * n_pad + len(members)] = members
        slot_of[members] = m * n_pad + np.arange(len(members))

    big = np.zeros((num_parts * n_pad, num_parts * n_pad), dtype=np.float32)
    valid = np.flatnonzero(perm >= 0)
    big[np.ix_(valid, valid)] = a_tilde[np.ix_(perm[valid], perm[valid])]
    a_blocks = (big.reshape(num_parts, n_pad, num_parts, n_pad)
                   .transpose(0, 2, 1, 3).copy())

    node_mask = (perm >= 0).reshape(num_parts, n_pad)
    neighbor_mask = (np.abs(a_blocks).sum(axis=(2, 3)) > 0)
    np.fill_diagonal(neighbor_mask, True)
    a_blocks = a_blocks.astype(np.float32)
    csr = compress_blocks(a_blocks, neighbor_mask, sizes=sizes,
                          row_counts=row_counts) if compressed else None
    return CommunityLayout(num_parts=num_parts, n_pad=n_pad, perm=perm,
                           a_blocks=a_blocks,
                           node_mask=node_mask, neighbor_mask=neighbor_mask,
                           sizes=sizes, block_csr=csr,
                           row_counts=row_counts, pad_mode=pad_mode)


# ---------------------------------------------------------------------------
# Synthetic benchmark graphs (Amazon Computers / Photo statistics, Table 2).
# The real datasets are unavailable offline; we match N / features / classes /
# train-test counts with a stochastic block model whose blocks align with the
# label classes, so community structure (the paper's premise) is present.
# ---------------------------------------------------------------------------

def synthetic_powerlaw_communities(num_parts: int, nodes_per_part: int = 32,
                                   attach: int = 2, p_in: float = 0.3,
                                   inter_edges: int = 4, seed: int = 0,
                                   num_classes: int = 4, feat_dim: int = 16,
                                   size_skew: float = 0.0
                                   ) -> tuple[Graph, Array]:
    """Graph of M dense communities whose *inter-community* topology is a
    preferential-attachment (Barabási–Albert) graph: block fan-in follows a
    power law, so nnz Ã blocks grows ~O(M·attach) while the dense layout is
    O(M²) — the regime where block compression and neighbour-only
    communication pay off.  Returns (graph, ground-truth partition).

    ``size_skew > 0`` makes the *community sizes themselves* power-law
    distributed (size ∝ rank^-skew, total held at M·nodes_per_part, min
    size 1), with the LARGE communities at the high (late, BA-peripheral)
    indices and the early hubs small — a dense small core relaying between
    big leaf communities.  Keeping size anti-correlated with block degree
    makes the benchmark isolate *padding* waste: the irreducible (true-row)
    wire volume stays comparable to the uniform graph's, so any global-pad
    overhead measured against it is pure pad bytes.  This is the regime
    where a single global ``n_pad`` wastes pad FLOPs/bytes proportional to
    the skew and size-aware (bucketed) padding pays (BENCH_speedup.json
    ``m32_ragged``).  ``size_skew=0`` reproduces the historic equal-size
    graphs bit-for-bit (same rng stream).
    """
    rng = np.random.default_rng(seed)
    m, n_c = num_parts, nodes_per_part
    if size_skew > 0:
        w = (np.arange(m) + 1.0) ** (-float(size_skew))
        w = w[::-1]                              # big sizes on the leaves
        sizes = np.maximum(1, np.floor(w / w.sum() * (m * n_c)).astype(int))
        # restore N == M·nodes_per_part: the min-size-1 bumps can overshoot
        # the floor() undershoot at extreme skew, so walk the correction
        # from the largest community down, never dropping any below 1
        delta = m * n_c - int(sizes.sum())
        i = m - 1
        while delta < 0 and i >= 0:
            take = min(int(sizes[i]) - 1, -delta)
            sizes[i] -= take
            delta += take
            i -= 1
        sizes[-1] += delta
    else:
        sizes = np.full(m, n_c, dtype=int)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    n = int(offsets[-1])
    part = np.repeat(np.arange(m, dtype=np.int32), sizes)

    edges: list[tuple[int, int]] = []
    # dense intra-community structure (ER with p_in, plus a ring so every
    # community is connected)
    for c in range(m):
        base, n_cc = int(offsets[c]), int(sizes[c])
        for i in range(n_cc):
            edges.append((base + i, base + (i + 1) % n_cc))
        pairs = np.argwhere(
            np.triu(rng.random((n_cc, n_cc)) < p_in, k=2))
        edges.extend((base + int(i), base + int(j)) for i, j in pairs)

    # preferential attachment over communities
    deg = np.ones(m)
    com_edges: set[tuple[int, int]] = set()
    for c in range(1, m):
        k = min(attach, c)
        probs = deg[:c] / deg[:c].sum()
        targets = rng.choice(c, size=k, replace=False, p=probs)
        for t in targets:
            com_edges.add((min(c, int(t)), max(c, int(t))))
            deg[c] += 1
            deg[t] += 1
    # each community edge becomes a few node-level bridge edges
    for c1, c2 in sorted(com_edges):
        for _ in range(inter_edges):
            u = int(offsets[c1]) + int(rng.integers(sizes[c1]))
            v = int(offsets[c2]) + int(rng.integers(sizes[c2]))
            edges.append((u, v))

    e = np.unique(np.sort(np.asarray(edges, dtype=np.int32), axis=1), axis=0)
    e = e[e[:, 0] != e[:, 1]]

    labels = (part % num_classes).astype(np.int32)
    centers = rng.normal(0.0, 1.0, size=(num_classes, feat_dim))
    feats = (centers[labels]
             + rng.normal(0, 0.8, size=(n, feat_dim))).astype(np.float32)
    order = rng.permutation(n)
    train_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[order[: n // 3]] = True
    test_mask[order[n // 3: 2 * n // 3]] = True
    return Graph(edges=e, features=feats, labels=labels,
                 train_mask=train_mask, test_mask=test_mask,
                 num_classes=num_classes), part


DATASET_STATS = {
    # name: (nodes, train, test, classes, features, avg_degree)
    "amazon_computers": (13752, 1000, 1000, 10, 767, 35.8),
    "amazon_photo": (7650, 800, 1000, 8, 745, 31.1),
    "amazon_computers_mini": (2752, 600, 600, 10, 767, 18.0),
    "amazon_photo_mini": (1530, 400, 400, 8, 745, 16.0),
}


def synthetic_sbm(name: str = "amazon_computers_mini", seed: int = 0,
                  p_in_out_ratio: float = 12.0) -> Graph:
    if name not in DATASET_STATS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_STATS)}")
    n, n_train, n_test, k, c0, deg = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=n).astype(np.int32)

    # SBM edge sampling: expected degree ``deg``, within-class edges
    # p_in_out_ratio times likelier than cross-class.
    p_out = deg / (n * (p_in_out_ratio / k + (1 - 1 / k)))
    p_in = p_in_out_ratio * p_out
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < prob, k=1)
    edges = np.argwhere(upper).astype(np.int32)

    # class-informative Gaussian features
    centers = rng.normal(0.0, 1.0, size=(k, c0)).astype(np.float32)
    feats = centers[labels] + rng.normal(0, 1.2, size=(n, c0)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8

    order = rng.permutation(n)
    train_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[order[:n_train]] = True
    test_mask[order[n_train:n_train + n_test]] = True
    return Graph(edges=edges, features=feats, labels=labels,
                 train_mask=train_mask, test_mask=test_mask, num_classes=k)
