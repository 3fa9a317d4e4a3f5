"""Multilevel coarsen→partition→uncoarsen graph partitioner (METIS scheme).

Pure-numpy implementation of the three-phase multilevel scheme that METIS
(Karypis & Kumar, 1998) made standard, and that Cluster-GCN relies on for
community-batched GCN training.  Same contract as
``repro_torch.core.graph.partition_graph`` — ``(N,) int32`` community ids, every
node assigned exactly once, part sizes under the hard cap ``ceil(N / M)`` —
so it drops into ``build_community_layout``, the trainers, benchmarks and
examples unchanged (exposed as ``partition_graph(method="multilevel")``).

Phase map (METIS name → function here):

  1. **Coarsening** (``_heavy_edge_matching`` + ``_contract``): repeated
     heavy-edge matching — visit vertices in random order, match each with
     its unmatched neighbour of maximum edge weight — then contract matched
     pairs into coarse vertices, summing node weights and accumulating
     parallel edge weights.  Dense regions (heavy accumulated edges)
     collapse first, so community structure survives coarsening.  Stops at
     ``coarsen_to`` vertices or when matching stalls (< 5% shrink).
  2. **Initial partitioning** (``_initial_partition``): on the coarsest
     graph, weight-aware BFS-grown seeds under a slackened weight cap
     (the greedy part of METIS' GGGP), followed by weighted
     Kernighan–Lin boundary refinement.
  3. **Uncoarsening** (``_refine`` at every level): project the partition
     through the matching maps and re-run boundary KL refinement at each
     finer level — moves are taken in descending-gain order (integer
     edge-weight gains, i.e. an array-sorted stand-in for the classic
     gain-bucket queue) under the level's weight cap.  At the finest level
     node weights are all one, so ``_enforce_cap`` can restore the strict
     ``ceil(N / M)`` balance cap exactly, moving minimum-cut-loss boundary
     nodes out of overfull parts.

Determinism: all randomness flows from one ``np.random.default_rng(seed)``;
ties break on the smallest vertex id.  Handles self-loops (dropped), isolated
vertices (self-matched, placed by the balance pass), ``num_parts == 1`` and
graphs smaller than ``coarsen_to`` (phases 1/3 become no-ops).
"""
from __future__ import annotations

import collections

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# weighted CSR graph
# ---------------------------------------------------------------------------

def _edges_to_csr(num_nodes: int, edges: Array
                  ) -> tuple[Array, Array, Array]:
    """(E, 2) undirected edge list -> CSR (xadj, adjncy, adjwgt).

    Self-loops are dropped; duplicate edges accumulate weight (the input
    contract stores each undirected edge once, but the partitioner must not
    depend on it).  Both directions are materialised.
    """
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return _accumulate_csr(num_nodes, src, dst,
                           np.ones(src.shape[0], dtype=np.int64))


def _accumulate_csr(n: int, src: Array, dst: Array, wgt: Array
                    ) -> tuple[Array, Array, Array]:
    """Build CSR from directed (src, dst, wgt) triples, summing parallels."""
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, wgt = key[order], src[order], dst[order], wgt[order]
    if key.size:
        uniq = np.concatenate([[True], key[1:] != key[:-1]])
        grp = np.cumsum(uniq) - 1
        src, dst = src[uniq], dst[uniq]
        wgt = np.bincount(grp, weights=wgt).astype(np.int64)
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    np.cumsum(xadj, out=xadj)
    return xadj, dst.astype(np.int64), wgt


# ---------------------------------------------------------------------------
# phase 1: coarsening
# ---------------------------------------------------------------------------

def _heavy_edge_matching(xadj: Array, adjncy: Array, adjwgt: Array,
                         vwgt: Array, maxvwgt: int,
                         rng: np.random.Generator) -> tuple[Array, int]:
    """One round of heavy-edge matching.  Returns (cmap, n_coarse):
    ``cmap[v]`` is v's coarse vertex id; matched pairs share an id,
    unmatched (or isolated) vertices keep their own.  A pair whose combined
    weight would exceed ``maxvwgt`` is never matched — METIS' guard against
    coarse vertices too heavy to place inside one part (without it, two
    whole communities can collapse into one unsplittable vertex)."""
    n = xadj.shape[0] - 1
    mate = np.full(n, -1, dtype=np.int64)
    for u in rng.permutation(n):
        if mate[u] >= 0:
            continue
        lo, hi = xadj[u], xadj[u + 1]
        nbrs, wgts = adjncy[lo:hi], adjwgt[lo:hi]
        free = (mate[nbrs] < 0) & (vwgt[u] + vwgt[nbrs] <= maxvwgt)
        best = u
        if free.any():
            nbrs, wgts = nbrs[free], wgts[free]
            top = wgts == wgts.max()
            best = int(nbrs[top].min())          # heaviest edge, lowest id
        mate[u], mate[best] = best, u            # best == u: self-match
    cmap = np.full(n, -1, dtype=np.int64)
    nc = 0
    for u in range(n):
        if cmap[u] < 0:
            cmap[u] = cmap[mate[u]] = nc
            nc += 1
    return cmap, nc


def _contract(xadj: Array, adjncy: Array, adjwgt: Array, vwgt: Array,
              cmap: Array, nc: int
              ) -> tuple[Array, Array, Array, Array]:
    """Contract matched pairs: coarse node weights are sums, parallel coarse
    edges accumulate weight, internal (now self-loop) edges vanish — exactly
    the weight bookkeeping that keeps coarse-level cuts equal to fine-level
    cuts under projection."""
    cvwgt = np.bincount(cmap, weights=vwgt, minlength=nc).astype(np.int64)
    src = np.repeat(np.arange(xadj.shape[0] - 1), np.diff(xadj))
    csrc, cdst = cmap[src], cmap[adjncy]
    keep = csrc != cdst
    cx, ca, cw = _accumulate_csr(nc, csrc[keep], cdst[keep], adjwgt[keep])
    return cx, ca, cw, cvwgt


# ---------------------------------------------------------------------------
# phase 2: initial partition of the coarsest graph
# ---------------------------------------------------------------------------

def _initial_partition(xadj: Array, adjncy: Array, adjwgt: Array,
                       vwgt: Array, num_parts: int, cap_w: float,
                       rng: np.random.Generator) -> Array:
    """Greedy graph growing (METIS' GGGP) under ``cap_w``: each part grows
    from a random unassigned seed by repeatedly absorbing the unassigned
    vertex with the heaviest edge connection to the part (not BFS order —
    the connectivity-greedy choice is what follows heavy coarse edges and
    keeps dense clusters whole).  Stragglers go to the lightest part."""
    n = xadj.shape[0] - 1
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)
    order = rng.permutation(n)
    cursor = 0
    neg_inf = -np.inf
    for p in range(num_parts):
        while cursor < n and part[order[cursor]] >= 0:
            cursor += 1
        if cursor >= n:
            break
        conn = np.full(n, neg_inf)               # -inf = not on the frontier
        node = int(order[cursor])
        while sizes[p] + vwgt[node] <= cap_w:
            part[node] = p
            sizes[p] += vwgt[node]
            conn[node] = neg_inf
            lo, hi = xadj[node], xadj[node + 1]
            for v, w in zip(adjncy[lo:hi], adjwgt[lo:hi]):
                if part[v] < 0:
                    conn[v] = max(conn[v], 0.0) + w
            node = int(np.argmax(conn))          # heaviest-connected, min id
            if conn[node] == neg_inf:
                break                            # frontier exhausted
    for node in np.flatnonzero(part < 0):
        p = int(np.argmin(sizes))
        part[node] = p
        sizes[p] += vwgt[node]
    return part


# ---------------------------------------------------------------------------
# phase 3: refinement (used at every level) + strict finest-level balance
# ---------------------------------------------------------------------------

def _refine(xadj: Array, adjncy: Array, adjwgt: Array, vwgt: Array,
            part: Array, num_parts: int, cap_w: float,
            rng: np.random.Generator, passes: int) -> Array:
    """Weighted boundary refinement with a real FM gain-bucket queue.

    The argsort stand-in this replaces re-scored and re-sorted every
    positive-gain candidate each pass and applied the snapshot order
    against drifted gains.  This is the classic Fiduccia–Mattheyses
    discipline instead: per pass every *boundary* vertex files its best
    move into ``buckets[gain]`` (integer edge-weight gains); moves pop
    from the current maximum bucket with lazy invalidation (``filed[u]``
    remembers the gain a vertex was filed under — stale entries are
    skipped or re-filed at their current gain) and the weight cap is
    re-validated at apply time.  Crucially, non-positive-gain moves are
    taken too (each vertex at most once per pass — ``locked``): the pass
    hill-climbs through plateaus and shallow minima, records the running
    cut delta, and afterwards ROLLS BACK to the best prefix of the move
    sequence.  An applied move re-files only the moved vertex's
    neighbours — O(moves·deg) bucket maintenance, and strictly stronger
    search than the positive-gain-only argsort passes (a pass can never
    end worse than it started; it can escape optima the old code was
    stuck in).
    """
    n = xadj.shape[0] - 1
    sizes = np.bincount(part, weights=vwgt, minlength=num_parts
                        ).astype(np.int64)

    def best_move(u: int) -> tuple[int, int]:
        """Highest-gain target for u (may be ≤ 0); -1 if u is interior."""
        lo, hi = xadj[u], xadj[u + 1]
        if lo == hi:
            return -1, 0
        nbr_parts = part[adjncy[lo:hi]]
        cur = int(part[u])
        if (nbr_parts == cur).all():
            return -1, 0                          # interior vertex
        conn = np.bincount(nbr_parts, weights=adjwgt[lo:hi],
                           minlength=num_parts)
        gains = conn - conn[cur]
        gains[cur] = np.iinfo(np.int64).min
        tgt = int(np.argmax(gains))
        return tgt, int(gains[tgt])

    for _ in range(passes):
        buckets: dict[int, collections.deque] = {}
        filed: dict[int, int] = {}                # vertex -> gain filed under
        locked = np.zeros(n, dtype=bool)

        def push(u: int) -> None:
            tgt, g = best_move(u)
            if tgt >= 0:
                buckets.setdefault(g, collections.deque()).append(u)
                filed[u] = g
            else:
                filed.pop(u, None)

        for u in range(n):
            push(u)
        history: list[tuple[int, int, int]] = []  # (u, from, gain)
        cum = best_cum = 0
        best_len = 0
        while buckets:
            g = max(buckets)
            queue = buckets[g]
            if not queue:
                del buckets[g]
                continue
            u = int(queue.popleft())
            if locked[u] or filed.get(u) != g:
                continue                          # stale entry
            tgt, g_now = best_move(u)
            if tgt < 0:
                filed.pop(u, None)
                continue
            if g_now != g:
                push(u)                           # re-file at current gain
                continue
            cur = int(part[u])
            if sizes[tgt] + vwgt[u] > cap_w or sizes[cur] - vwgt[u] <= 0:
                filed.pop(u, None)
                continue
            part[u] = tgt
            sizes[cur] -= vwgt[u]
            sizes[tgt] += vwgt[u]
            locked[u] = True
            filed.pop(u, None)
            history.append((u, cur, g))
            cum += g
            if cum > best_cum:
                best_cum, best_len = cum, len(history)
            for v in adjncy[xadj[u]:xadj[u + 1]]:
                if not locked[v]:
                    push(int(v))
        # roll back to the best prefix of the move sequence (classic FM):
        # the pass keeps only the moves up to the maximum cumulative gain
        for u, src, _ in reversed(history[best_len:]):
            tgt = int(part[u])
            part[u] = src
            sizes[tgt] -= vwgt[u]
            sizes[src] += vwgt[u]
        if best_cum <= 0:
            break
    return part


def _enforce_cap(xadj: Array, adjncy: Array, adjwgt: Array, part: Array,
                 num_parts: int, cap: int) -> Array:
    """Finest level only (unit node weights): evict minimum-cut-loss nodes
    from overfull parts into the least-loaded parts until every size is
    under the strict ``ceil(N / M)`` cap the contract promises."""
    sizes = np.bincount(part, minlength=num_parts).astype(np.int64)
    for p in range(num_parts):
        while sizes[p] > cap:
            members = np.flatnonzero(part == p)
            tgt = int(np.argmin(np.where(np.arange(num_parts) == p,
                                         np.iinfo(np.int64).max, sizes)))
            best_u, best_loss = int(members[0]), None
            for u in members:
                lo, hi = xadj[u], xadj[u + 1]
                conn = np.bincount(part[adjncy[lo:hi]],
                                   weights=adjwgt[lo:hi],
                                   minlength=num_parts)
                loss = int(conn[p] - conn[tgt])
                if best_loss is None or loss < best_loss:
                    best_u, best_loss = int(u), loss
            part[best_u] = tgt
            sizes[p] -= 1
            sizes[tgt] += 1
    return part


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def multilevel_partition(num_nodes: int, edges: Array, num_parts: int,
                         seed: int = 0, refine_iters: int = 4,
                         coarsen_to: int | None = None,
                         balance: float = 1.05) -> Array:
    """Multilevel coarsen→partition→uncoarsen.  Contract-compatible with
    ``repro_torch.core.graph.partition_graph``: (N,) int32, every node assigned,
    sizes ≤ ceil(N / M).

    ``balance`` is the weight-cap slack used *during* coarse-level
    refinement (METIS' imbalance tolerance); the finest level always ends
    with the strict unit-weight cap restored.
    """
    if num_parts <= 0:
        raise ValueError(f"num_parts must be positive, got {num_parts}")
    if num_parts == 1:
        return np.zeros(num_nodes, dtype=np.int32)
    rng = np.random.default_rng(seed)
    cap = int(np.ceil(num_nodes / num_parts))
    if coarsen_to is None:
        # small multiple of the part count: deep enough that one coarse
        # vertex ≈ one dense cluster, so the initial partition assigns
        # clusters wholesale (METIS coarsens to ~O(k) vertices too)
        coarsen_to = max(2 * num_parts, 32)

    xadj, adjncy, adjwgt = _edges_to_csr(num_nodes, edges)
    vwgt = np.ones(num_nodes, dtype=np.int64)

    levels: list[tuple] = []          # (cmap, xadj, adjncy, adjwgt, vwgt)
    while xadj.shape[0] - 1 > coarsen_to:
        cmap, nc = _heavy_edge_matching(xadj, adjncy, adjwgt, vwgt, cap,
                                        rng)
        if nc > 0.95 * (xadj.shape[0] - 1):      # matching stalled
            break
        levels.append((cmap, xadj, adjncy, adjwgt, vwgt))
        xadj, adjncy, adjwgt, vwgt = _contract(
            xadj, adjncy, adjwgt, vwgt, cmap, nc)

    # coarse-level weight cap: the strict node cap with refinement slack,
    # never below the heaviest single coarse vertex (which must fit
    # somewhere for the projection to stay feasible; matching keeps every
    # coarse vertex ≤ cap, so this only widens for degenerate inputs)
    cap_w = max(float(cap) * balance, float(vwgt.max()))
    part = _initial_partition(xadj, adjncy, adjwgt, vwgt, num_parts, cap_w,
                              rng)
    part = _refine(xadj, adjncy, adjwgt, vwgt, part, num_parts, cap_w,
                   rng, refine_iters)

    while levels:
        cmap, xadj, adjncy, adjwgt, vwgt = levels.pop()
        part = part[cmap]                         # project to finer level
        cap_w = max(float(cap) * balance, float(vwgt.max()))
        part = _refine(xadj, adjncy, adjwgt, vwgt, part, num_parts, cap_w,
                       rng, refine_iters)

    part = _enforce_cap(xadj, adjncy, adjwgt, part, num_parts, cap)
    part = _refine(xadj, adjncy, adjwgt, np.ones(num_nodes, np.int64),
                   part, num_parts, float(cap), rng, refine_iters)
    return part.astype(np.int32)
