"""Round colouring and community batch sampling of the multi-shard trainer.

The port's copy of ``ring_round_coloring`` and ``CommunityBatchSampler``
from ``repro.sharding.partition``: the exchange plan colours its
shard-to-shard messages into rounds with the first, and the minibatching
trainer draws its shard batches with the second.  Both are numpy only and
must give the reference's rounds and batches exactly
(tests/test_torch_messages.py).
"""
from __future__ import annotations

import numpy as np


def ring_round_coloring(pairs, n_shards: int) -> dict[int, list]:
    """Colour directed shard-to-shard messages into exchange rounds.

    ``pairs``: iterable of (src, dst) shard edges (src != dst).  Two
    messages can share a round only if the round's pairs
    form a partial permutation (each shard sends to at most one destination
    and receives from at most one source) — exactly a proper *edge
    colouring* of the bipartite multigraph with sender roles on the left,
    receiver roles on the right, and one edge per message.  König's theorem
    says Δ = max(out-degree, in-degree) colours always suffice, and the
    constructive proof (greedy assignment with an alternating-path colour
    flip on conflict) achieves it in O(E·Δ), so the returned schedule is
    round-minimal — the historic ring-offset colouring
    ``(dst - src) mod n_shards`` could burn up to n_shards−1 rounds on a
    Δ=2 skewed topology.  The schedule is static: a step runs it as a
    fixed sequence of rounds.  Returns
    {colour: sorted [(src, dst), ...]} with colours contiguous from 0.
    """
    edges: list[tuple[int, int]] = []
    for src, dst in pairs:
        src, dst = int(src), int(dst)
        if not (0 <= src < n_shards and 0 <= dst < n_shards):
            raise ValueError(f"shard pair {(src, dst)} out of range "
                             f"for n_shards={n_shards}")
        if src == dst:
            raise ValueError(f"self-edge {(src, dst)} needs no wire")
        edges.append((src, dst))
    # colour -> partner maps per role-node; colour_of keyed by edge index
    # so repeated (src, dst) messages (multigraph) stay well-defined
    send_c: list[dict[int, int]] = [{} for _ in range(n_shards)]
    recv_c: list[dict[int, int]] = [{} for _ in range(n_shards)]
    colour_of: list[int] = [-1] * len(edges)

    def _free(used: dict[int, int]) -> int:
        c = 0
        while c in used:
            c += 1
        return c

    for ei in sorted(range(len(edges)), key=lambda i: edges[i]):
        u, v = edges[ei]
        cu, cv = _free(send_c[u]), _free(recv_c[v])
        if cu != cv:
            # cu is free at sender u but in use at receiver v: flip the
            # alternating cu/cv path starting at v so cu frees up at v too.
            # The path cannot reach u (cu is free there), so after the
            # flip cu is free at both endpoints.
            path: list[int] = []
            node, at_recv, want = v, True, cu
            while True:
                nxt = (recv_c if at_recv else send_c)[node].get(want)
                if nxt is None:
                    break
                path.append(nxt)
                s, d = edges[nxt]
                node = s if at_recv else d
                at_recv = not at_recv
                want = cv if want == cu else cu
            for pe in path:
                s, d = edges[pe]
                del send_c[s][colour_of[pe]]
                del recv_c[d][colour_of[pe]]
            for pe in path:
                s, d = edges[pe]
                new = cv if colour_of[pe] == cu else cu
                colour_of[pe] = new
                send_c[s][new] = pe
                recv_c[d][new] = pe
        colour_of[ei] = cu
        send_c[u][cu] = ei
        recv_c[v][cu] = ei

    rounds: dict[int, list] = {}
    for ei, (u, v) in enumerate(edges):
        rounds.setdefault(colour_of[ei], []).append((u, v))
    for colour, members in rounds.items():
        members.sort()
        if len(set(s for s, _ in members)) != len(members) or \
                len(set(d for _, d in members)) != len(members):
            raise ValueError(f"round {colour} is not a partial permutation: "
                             f"{members}")
    return dict(sorted(rounds.items()))


class CommunityBatchSampler:
    """Seeded, balance-aware random multi-cluster batches (Cluster-GCN).

    Sampling granularity is the SHARD — a shard's k communities always
    travel together (they share a device, a packed state plane and an
    exchange-plan slot table, so sampling below shard granularity would
    fragment the compiled program without saving resident bytes).  With
    one community per shard (the benchmark deployment) this is exact
    per-community sampling, the paper-faithful regime.

    Each *cycle* partitions all ``n_shards`` shards into
    ``num_batches = min(n_shards, round(1/batch_fraction))`` batches, so
    every shard is sampled exactly once per cycle — staleness is bounded
    by ``num_batches - 1`` rounds by construction.  Batches are
    balance-aware: shards are shuffled (seeded per cycle), stably sorted
    heaviest-first by ``weights`` (Σ bucket rows — the resident/compute
    load), and greedily dropped into the lightest batch, so a size-skewed
    partition does not stack its giants into one round.  Deterministic
    for a fixed ``seed``: batch ``t`` is a pure function of (seed, t).
    """

    def __init__(self, n_shards: int, batch_fraction: float, seed: int = 0,
                 weights: "np.ndarray | None" = None):
        if not 0.0 < batch_fraction <= 1.0:
            raise ValueError(f"batch_fraction must be in (0, 1], got "
                             f"{batch_fraction!r}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.batch_fraction = float(batch_fraction)
        self.num_batches = min(self.n_shards,
                               max(1, int(round(1.0 / batch_fraction))))
        self.seed = int(seed)
        if weights is None:
            w = np.ones(self.n_shards, dtype=np.float64)
        else:
            w = np.asarray(weights, dtype=np.float64)
            if w.shape != (self.n_shards,):
                raise ValueError(f"weights must be ({self.n_shards},), "
                                 f"got {w.shape}")
        self.weights = np.maximum(w, 1.0)
        self._cycles: dict[int, tuple[tuple[int, ...], ...]] = {}

    def cycle(self, c: int) -> tuple[tuple[int, ...], ...]:
        """The ``num_batches`` shard batches of cycle ``c`` (memoised)."""
        if c not in self._cycles:
            rng = np.random.default_rng((self.seed, int(c)))
            order = rng.permutation(self.n_shards)
            # heaviest first, ties in the cycle's random order (stable)
            order = order[np.argsort(-self.weights[order], kind="stable")]
            batches: list[list[int]] = [[] for _ in range(self.num_batches)]
            loads = np.zeros(self.num_batches)
            for s in order:
                b = int(np.argmin(loads))
                batches[b].append(int(s))
                loads[b] += self.weights[s]
            self._cycles[c] = tuple(tuple(sorted(b)) for b in batches)
        return self._cycles[c]

    def batch(self, t: int) -> tuple[int, ...]:
        """Sampled shard ids of round ``t`` (sorted, non-empty)."""
        c, i = divmod(int(t), self.num_batches)
        return self.cycle(c)[i]
