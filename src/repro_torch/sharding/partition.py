"""Round colouring and community batch sampling of the multi-shard
trainer, and the sharding rules of the language models.

The port's copy of ``repro.sharding.partition``:

  * ``ring_round_coloring`` and ``CommunityBatchSampler``: the exchange
    plan colours its shard-to-shard messages into rounds with the first,
    and the minibatching trainer draws its shard batches with the second.
    Both are numpy only and must give the reference's rounds and batches
    exactly (tests/test_torch_messages.py).
  * ``param_specs``, ``opt_state_specs``, ``batch_specs`` and
    ``cache_specs``: parameter / optimizer-state / batch / cache trees to
    trees of specs, the reference's standard 2-D "megatron + FSDP" layout
    with expert-parallel MoE — batch dims over the data axes (``pod``,
    ``data``), experts and the embedding's vocabulary over ``model``,
    weight matrices' output features over ``model`` (the input features
    of down / out projections), and above ``FSDP_THRESHOLD`` parameters
    the other feature dim over ``data``; norms, biases and scalars
    replicated, the stacked layer dim never sharded here (the layerwise
    ADMM trainer places blocks over ``model`` itself).  An axis is
    assigned only where it divides the dim.  A spec is a tuple with one
    entry per dim: ``None``, an axis name, or a tuple of axis names (the
    reference's ``PartitionSpec``, which writes a one-name tuple as the
    name).  The rules read only a mesh's ``shape`` and ``axis_names`` and
    the leaves' ``shape`` (meta or fake tensors do), so they need no
    group (tests/test_torch_mesh_specs.py).
  * ``local_shape``, ``local_slice``, ``place`` and ``gather``: a rank's
    slices of tensors placed by those specs (a named sharding's chunks,
    row-major over an entry's axes) and back over the ranks — the
    parameters by ``param_specs``, an optimizer state by
    ``opt_state_specs`` (Adam's moments as the parameters), each gathered
    whole for the tests and checkpoints; ``data_slice`` cuts a gradient
    summed over the data ranks back to a rank's FSDP slice;
    ``slicer`` keeps a rank's slices of a tree as it is drawn
    (``Model.init(mesh=...)``); ``logits_spec`` is where a rank's logits
    lie (tests/test_torch_hints.py).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.util import tree as tree_lib

FSDP_THRESHOLD = 8e9    # params; above this, shard input dims over 'data'


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


# ---------------------------------------------------------------------------
# sharding rules of the language models
# ---------------------------------------------------------------------------

def P(*entries) -> tuple:
    """A spec: one entry per dim, a one-name tuple written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _path_str(path) -> str:
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k)
                    for k in path)


def _map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over a tree's leaves, in its structure."""
    if tree is None:
        return None
    kids = tree_lib._children(tree)
    if kids is None:
        return fn(prefix, tree)
    return tree_lib._rebuild(tree, [_map_with_path(fn, child, prefix + (k,))
                                    for k, child in kids])


def _assign(shape, wants, mesh) -> tuple:
    """wants: list of (dim_idx, axis_name) in priority order; returns a
    spec assigning each axis at most once, only if it divides."""
    spec: list[Optional[str]] = [None] * len(shape)
    used: set[str] = set()
    for dim, axis in wants:
        if axis in used or axis not in mesh.axis_names:
            continue
        if dim < len(shape) and shape[dim] % _axis_size(mesh, axis) == 0 \
                and spec[dim] is None and shape[dim] > 1:
            spec[dim] = axis
            used.add(axis)
    return P(*spec)


def param_specs(cfg, mesh, params_shapes: Any) -> Any:
    """params_shapes: a tree of tensors (meta or fake tensors will do)."""
    rule = param_rule(cfg, mesh)
    return _map_with_path(lambda path, leaf: rule(path, tuple(leaf.shape)),
                          params_shapes)


def param_rule(cfg, mesh):
    """``param_specs``'s rule as a function of (key path, full shape)."""
    fsdp = cfg.param_count() > FSDP_THRESHOLD

    def rule(path, shape):
        name = _path_str(path)
        nd = len(shape)
        stacked = "stack/" in name or name.startswith("stack")
        off = 1 if stacked else 0        # leading layer-stack dim

        if nd - off <= 1:                # norms, biases, scalars, lam
            return P(*([None] * nd))

        # embedding: (V, D) table / (D, V) unembed
        if "embedding" in name:
            if "table" in name:
                wants = [(0, "model")] + ([(1, "data")] if fsdp else [])
            else:
                wants = [(1, "model")] + ([(0, "data")] if fsdp else [])
            return _assign(shape, wants, mesh)

        # MoE experts: (L, E, d, f) -> E over model, d over data (fsdp)
        if any(k in name for k in ("w_gate", "w_up", "w_down")) \
                and nd - off == 3:
            wants = [(off, "model")] + ([(off + 1, "data")] if fsdp else [])
            return _assign(shape, wants, mesh)
        if "router" in name:
            return P(*([None] * nd))

        # RG-LRU block-diagonal gates (L, NB, bs, bs): replicate (small)
        if "gate_a" in name or "gate_x" in name:
            return P(*([None] * nd))
        # depthwise conv (L, k, W): shard channel dim over model
        if "/conv/" in name or name.endswith("conv/w") or "conv/b" in name:
            return _assign(shape, [(nd - 1, "model")], mesh)

        # generic 2D weight (L, in, out): output dim over 'model', input
        # dim over 'data' under FSDP; "down"/"out"/"o" projections have
        # their *input* as the parallel dim, so the contraction stays
        # local after the up-projection's sharding
        is_reduce_in = any(name.endswith(s) or f"/{s}" in name.split("/")[-1]
                           for s in ("down", "out", "o", "out_proj"))
        if nd - off == 2:
            if is_reduce_in:
                wants = [(off, "model")] + ([(off + 1, "data")] if fsdp
                                            else [])
            else:
                wants = [(off + 1, "model")] + ([(off, "data")] if fsdp
                                                else [])
            return _assign(shape, wants, mesh)

        return P(*([None] * nd))

    return rule


def opt_state_specs(cfg, mesh, params_shapes: Any, opt_shapes: Any) -> Any:
    """Adam moments mirror the parameters' specs; scalars replicated."""
    pspecs = param_specs(cfg, mesh, params_shapes)
    if isinstance(opt_shapes, dict) and "m" in opt_shapes:
        return {"m": pspecs, "v": pspecs, "t": P()}
    # other optimizers' state (``()`` for SGD): every leaf replicated
    return tree_lib.tree_map(lambda _: P(), opt_shapes)


def batch_specs(cfg, mesh, batch_shapes: Any) -> Any:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        b = shape[0]
        total_dp = int(np.prod([_axis_size(mesh, a) for a in dp]))
        spec: list = [None] * len(shape)
        if b % total_dp == 0 and b >= total_dp:
            spec[0] = dp
        elif b % _axis_size(mesh, "data") == 0 \
                and b >= _axis_size(mesh, "data"):
            spec[0] = "data"
        # embeddings inputs (B, S, D): D replicated
        if len(shape) == 3 and shape[-1] == cfg.d_model:
            spec[-1] = None
        return P(*spec)

    return _map_with_path(rule, batch_shapes)


def cache_specs(cfg, mesh, cache_shapes: Any) -> Any:
    """Decode caches: (L, B, S, H, hd) etc.  Batch over the data axes when
    it divides; otherwise (B = 1 long-context) the sequence / window dim
    over 'data'; heads / state dims over 'model' when divisible."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    total_dp = int(np.prod([_axis_size(mesh, a) for a in dp]))

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return P(*([None] * nd))
        spec: list = [None] * nd
        # dim 0 is the stacked layer dim; dim 1 the batch
        if shape[1] % total_dp == 0 and shape[1] >= total_dp:
            spec[1] = dp
        elif nd >= 3 and shape[1] == 1:
            # B = 1: sequence parallelism over 'data'
            if shape[2] % _axis_size(mesh, "data") == 0 and shape[2] > 1:
                spec[2] = "data"
        # heads / channel dims over 'model' (k/v: dim 3; ssm h: dim 2)
        for d in range(nd - 1, 1, -1):
            if spec[d] is None and shape[d] % _axis_size(mesh, "model") == 0 \
                    and shape[d] >= _axis_size(mesh, "model") and d != 2:
                spec[d] = "model"
                break
        return P(*spec)

    return _map_with_path(rule, cache_shapes)


# ---------------------------------------------------------------------------
# placement: a rank's slices of full tensors, and back
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def model_dim(spec) -> Optional[int]:
    """The dim a spec places over ``model``, or None."""
    for d, entry in enumerate(spec):
        if "model" in entry_axes(entry):
            return d
    return None


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's slice of a tensor of ``shape`` placed by
    ``spec`` (``NamedSharding(mesh, spec).shard_shape``): each dim divided
    by the product of its entry's axes."""
    shape = tuple(shape)
    return tuple(d // int(np.prod([_axis_size(mesh, a)
                                   for a in entry_axes(e)]))
                 for d, e in zip(shape, spec)) + shape[len(spec):]


def _chunk(entry, mesh) -> tuple[int, int]:
    """(this rank's chunk, number of chunks) of a dim placed by ``entry``:
    row-major over the entry's axes, as a named sharding orders them."""
    coords = mesh.coords
    index, count = 0, 1
    for a in entry_axes(entry):
        size = _axis_size(mesh, a)
        index = index * size + (coords[a] if a in mesh.axis_names else 0)
        count *= size
    return index, count


def local_slice(x, spec, mesh):
    """This rank's slice of a full tensor ``x`` placed by ``spec`` (a
    view)."""
    for dim, entry in enumerate(spec):
        i, n = _chunk(entry, mesh)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its tree of specs."""
    kids = tree_lib._children(tree)
    if kids is None:
        return fn(tree, specs)

    def child(key):
        if isinstance(key, str) and key.startswith("."):
            return getattr(specs, key[1:])
        return specs[key]
    return tree_lib._rebuild(tree, [_zip_map(fn, c, child(k))
                                    for k, c in kids])


def place(tree, specs, mesh):
    """This rank's slice of every full tensor of ``tree``, each a
    contiguous copy (the full tree can then be dropped)."""
    import torch
    return _zip_map(lambda x, spec: local_slice(torch.as_tensor(x), spec,
                                                mesh).clone(
        memory_format=torch.contiguous_format), tree, specs)


def map_specs(fn, specs):
    """``fn(spec)`` over a tree of specs (a spec is a tuple: a leaf
    here)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def spec_at(specs, path):
    """The spec at a leaf's key ``path`` of a tree of specs."""
    for key in path:
        specs = getattr(specs, key[1:]) if isinstance(key, str) \
            and key.startswith(".") else specs[key]
    return specs


def data_slice(x, spec, mesh):
    """This rank's slice of ``x`` along the data axes only: a leaf
    all-gathered over them (the FSDP leg) whose gradient has been summed
    over the data ranks, cut back to the rank's part (``spec`` minus
    ``model``, whose slice ``x`` already is)."""
    return local_slice(x, drop_axes(spec, ("model",)), mesh)


def drop_axes(spec, axes) -> tuple:
    """``spec`` with ``axes`` taken out of every entry."""
    return P(*[tuple(a for a in entry_axes(e) if a not in axes) or None
               for e in spec])


def gather_leaf(x, spec, mesh, comm, axes=None, back: str = "scatter"):
    """A rank's slice ``x`` (placed by ``spec``) all-gathered along
    ``axes`` (every axis of the spec by default): along each dim, the
    entry's axes from the minor one out, so the chunks join row-major.
    ``back`` is each all-gather's backward (``MeshCollectives.
    gather_line``)."""
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if a in mesh.axis_names and (axes is None or a in axes) \
                    and _axis_size(mesh, a) > 1:
                x = comm.gather_line(x, dim, mesh.axis(a), back)
    return x


def gather(tree, specs, mesh, comm, axes=None):
    """``place``'s inverse over the ranks: every leaf all-gathered along
    ``axes`` (all of them by default) — every rank of ``mesh`` calls it
    with the same tree structure."""
    return _zip_map(lambda x, spec: gather_leaf(x, spec, mesh, comm, axes),
                    tree, specs)


def slicer(cfg, mesh):
    """``keep(tree, prefix, count=None)``: this rank's slices (contiguous
    copies) of a freshly drawn parameter tree at key path ``prefix`` — one
    layer of a stack of ``count`` when given — by ``param_specs``'s rule,
    so a rank never holds more than one drawn leaf whole."""
    import torch
    rule = param_rule(cfg, mesh)

    def keep(tree, prefix: tuple, count: Optional[int] = None):
        def one(path, leaf):
            lead = (count,) if count is not None else ()
            spec = rule(prefix + path, lead + tuple(leaf.shape))[len(lead):]
            return local_slice(leaf, spec, mesh).clone(
                memory_format=torch.contiguous_format)
        return _map_with_path(one, tree)
    return keep


def local_filled(tree, specs, mesh, device, fills: dict):
    """A tree of this rank's slices of constant tensors: each leaf of
    ``tree`` (meta tensors will do) as its local shape by ``specs``, filled
    with ``fills`` of its last key (0 by default)."""
    import torch

    def one(path, leaf):
        spec = specs
        for key in path:
            spec = spec[key]
        return torch.full(local_shape(leaf.shape, spec, mesh),
                          fills.get(path[-1], 0), dtype=leaf.dtype,
                          device=device)
    return _map_with_path(one, tree)


def logits_spec(cfg, mesh, batch: int) -> tuple:
    """Where a rank's logits lie (src/repro/launch/dryrun.py:80-83): rows
    over the data axes when they divide the batch, the vocabulary over
    ``model`` when it divides (the embedding's placement)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    total = int(np.prod([_axis_size(mesh, a) for a in dp]))
    bsp = dp if dp and batch % total == 0 and batch >= total else None
    vsp = "model" if cfg.vocab_size % _axis_size(mesh, "model") == 0 \
        else None
    return P(bsp, None, vsp)
