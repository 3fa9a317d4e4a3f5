"""The benchmark's community assignment: a multilevel partitioner.

A frozen copy of the scheme of ``repro_torch.sharding.multilevel`` (METIS'
three phases: heavy-edge matching and contraction down to a few dozen
vertices, greedy graph growing on the coarsest graph, refinement at every
level on the way back, and the strict cap ``ceil(N / M)`` restored at the
finest), kept here so that the yardstick does not move with the program.
One departure: the program refines with a Fiduccia-Mattheyses queue, one
vertex at a time, which takes about two minutes at 13,752 nodes on a
desktop core; this copy refines with whole-array passes (every boundary
vertex's best move by gain, the positive ones applied in order of gain up
to each part's room, the pass kept only if the cut fell), which takes
about a second.  Deterministic for a seed; (N,) int32 ids in [0, M).
"""
from __future__ import annotations

import numpy as np


def _csr(n: int, src: np.ndarray, dst: np.ndarray, wgt: np.ndarray):
    """CSR (xadj, adjncy, adjwgt) of directed triples, parallels summed."""
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, wgt = key[order], src[order], dst[order], wgt[order]
    if key.size:
        first = np.concatenate([[True], key[1:] != key[:-1]])
        grp = np.cumsum(first) - 1
        src, dst = src[first], dst[first]
        wgt = np.bincount(grp, weights=wgt).astype(np.int64)
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    np.cumsum(xadj, out=xadj)
    return xadj, dst.astype(np.int64), wgt


def _match(xadj, adjncy, adjwgt, vwgt, maxvwgt, rng):
    """One round of heavy-edge matching: (coarse id of each vertex, count)."""
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
            best = int(nbrs[wgts == wgts.max()].min())
        mate[u], mate[best] = best, u
    lead = np.minimum(np.arange(n), mate)
    _, cmap = np.unique(lead, return_inverse=True)
    return cmap.astype(np.int64), int(cmap.max()) + 1


def _contract(xadj, adjncy, adjwgt, vwgt, cmap, nc):
    cvwgt = np.bincount(cmap, weights=vwgt, minlength=nc).astype(np.int64)
    src = np.repeat(np.arange(xadj.shape[0] - 1), np.diff(xadj))
    csrc, cdst = cmap[src], cmap[adjncy]
    keep = csrc != cdst
    return _csr(nc, csrc[keep], cdst[keep], adjwgt[keep]) + (cvwgt,)


def _grow(xadj, adjncy, adjwgt, vwgt, m, cap_w, rng):
    """Greedy graph growing on the coarsest graph under ``cap_w``."""
    n = xadj.shape[0] - 1
    part = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(m, dtype=np.int64)
    order = rng.permutation(n)
    cursor = 0
    for p in range(m):
        while cursor < n and part[order[cursor]] >= 0:
            cursor += 1
        if cursor >= n:
            break
        conn = np.full(n, -np.inf)
        node = int(order[cursor])
        while sizes[p] + vwgt[node] <= cap_w:
            part[node] = p
            sizes[p] += vwgt[node]
            conn[node] = -np.inf
            lo, hi = xadj[node], xadj[node + 1]
            nb = adjncy[lo:hi]
            free = part[nb] < 0
            conn[nb[free]] = np.maximum(conn[nb[free]], 0.0) + adjwgt[lo:hi][free]
            node = int(np.argmax(conn))
            if conn[node] == -np.inf:
                break
    for node in np.flatnonzero(part < 0):
        p = int(np.argmin(sizes))
        part[node] = p
        sizes[p] += vwgt[node]
    return part


def _connections(xadj, adjncy, adjwgt, part, m):
    """(n, m) edge weight from each vertex into each part."""
    n = xadj.shape[0] - 1
    src = np.repeat(np.arange(n), np.diff(xadj))
    return np.bincount(src * m + part[adjncy], weights=adjwgt,
                       minlength=n * m).reshape(n, m)


def _cut(xadj, adjncy, adjwgt, part):
    src = np.repeat(np.arange(xadj.shape[0] - 1), np.diff(xadj))
    return int(adjwgt[part[src] != part[adjncy]].sum()) // 2


def _refine(xadj, adjncy, adjwgt, vwgt, part, m, cap_w, passes):
    """Whole-array boundary passes: each vertex's best target by gain; the
    positive moves, in order of gain, while the target has room and the
    source keeps a vertex; a pass that does not lower the cut is undone
    and ends the refinement."""
    n = xadj.shape[0] - 1
    best_cut = _cut(xadj, adjncy, adjwgt, part)
    for _ in range(passes):
        conn = _connections(xadj, adjncy, adjwgt, part, m)
        own = conn[np.arange(n), part]
        gain = conn - own[:, None]
        gain[np.arange(n), part] = -np.inf
        tgt = np.argmax(gain, axis=1)
        g = gain[np.arange(n), tgt]
        cand = np.flatnonzero(g > 0)
        if cand.size == 0:
            break
        cand = cand[np.lexsort((cand, -g[cand]))]
        sizes = np.bincount(part, weights=vwgt, minlength=m)
        new = part.copy()
        for p in range(m):
            into = cand[tgt[cand] == p]
            room = cap_w - sizes[p]
            into = into[np.cumsum(vwgt[into]) <= room]
            new[into] = p
        # a source part keeps at least one vertex
        for p in range(m):
            if not (new == p).any():
                keep = np.flatnonzero(part == p)[0]
                new[keep] = p
        cut = _cut(xadj, adjncy, adjwgt, new)
        if cut >= best_cut:
            break
        part, best_cut = new, cut
    return part


def _enforce_cap(xadj, adjncy, adjwgt, part, m, cap):
    """Finest level: move the cheapest members of each overfull part into
    the parts with room until every part holds at most ``cap``."""
    n = xadj.shape[0] - 1
    for p in range(m):
        sizes = np.bincount(part, minlength=m)
        extra = int(sizes[p] - cap)
        if extra <= 0:
            continue
        conn = _connections(xadj, adjncy, adjwgt, part, m)
        members = np.flatnonzero(part == p)
        room = np.maximum(cap - sizes, 0)
        room[p] = 0
        for q in np.argsort(-room, kind="stable"):
            if extra <= 0 or room[q] == 0:
                break
            loss = conn[members, p] - conn[members, q]
            take = members[np.lexsort((members, loss))][:min(extra, room[q])]
            part[take] = q
            members = np.setdiff1d(members, take)
            extra -= take.size
    return part


def multilevel_partition(num_nodes: int, edges: np.ndarray, num_parts: int,
                         seed: int, passes: int = 8,
                         balance: float = 1.05) -> np.ndarray:
    """Community ids (N,) int32 of ``num_parts`` parts of at most
    ``ceil(N / num_parts)`` nodes each."""
    if num_parts == 1:
        return np.zeros(num_nodes, dtype=np.int32)
    rng = np.random.default_rng(seed)
    cap = int(np.ceil(num_nodes / num_parts))
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    xadj, adjncy, adjwgt = _csr(
        num_nodes, np.concatenate([e[:, 0], e[:, 1]]),
        np.concatenate([e[:, 1], e[:, 0]]),
        np.ones(2 * e.shape[0], dtype=np.int64))
    vwgt = np.ones(num_nodes, dtype=np.int64)
    levels = []
    while xadj.shape[0] - 1 > max(2 * num_parts, 32):
        cmap, nc = _match(xadj, adjncy, adjwgt, vwgt, cap, rng)
        if nc > 0.95 * (xadj.shape[0] - 1):
            break
        levels.append((cmap, xadj, adjncy, adjwgt, vwgt))
        xadj, adjncy, adjwgt, vwgt = _contract(xadj, adjncy, adjwgt, vwgt,
                                               cmap, nc)
    cap_w = max(cap * balance, float(vwgt.max()))
    part = _grow(xadj, adjncy, adjwgt, vwgt, num_parts, cap_w, rng)
    part = _refine(xadj, adjncy, adjwgt, vwgt, part, num_parts, cap_w,
                   passes)
    while levels:
        cmap, xadj, adjncy, adjwgt, vwgt = levels.pop()
        part = part[cmap]
        cap_w = max(cap * balance, float(vwgt.max()))
        part = _refine(xadj, adjncy, adjwgt, vwgt, part, num_parts, cap_w,
                       passes)
    part = _enforce_cap(xadj, adjncy, adjwgt, part, num_parts, cap)
    part = _refine(xadj, adjncy, adjwgt, vwgt, part, num_parts, float(cap),
                   passes)
    return part.astype(np.int32)
