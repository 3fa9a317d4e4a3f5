"""What the benchmark takes from the program under test, ``repro_torch``:
its Parallel ADMM trainer, its kernel launch counters, and the trainer's
own layout tables to read its iterates back in node order.  Nothing here
computes a result the benchmark judges.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def build_trainer(config: dict, workload: dict, graph, part: np.ndarray,
                  seed: int, device, mesh=None):
    """``ParallelADMMTrainer`` on the benchmark's graph and assignment,
    with the configuration's widths and constants and the workload's
    flags."""
    from repro_torch.core import gcn
    from repro_torch.core import graph as pgraph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.core.subproblems import ADMMConfig
    g = pgraph.Graph(edges=graph.edges, features=graph.features,
                     labels=graph.labels, train_mask=graph.train_mask,
                     test_mask=graph.test_mask,
                     num_classes=graph.num_classes)
    cfg = gcn.GCNConfig(layer_dims=tuple(config["layer_dims"]),
                        activation=config["activation"])
    admm = ADMMConfig(**config["admm"])
    return ParallelADMMTrainer(
        cfg, admm, g, num_parts=workload["parts"], seed=seed,
        config=TrainerConfig(**workload["trainer"]), part=part,
        device=device, n_shards=workload.get("shards", 1), mesh=mesh)


class NodeReader:
    """Reads the trainer's iterates and aggregates in node order through
    its layout: the community-blocked slot of each node
    (``layout.perm``) and, for packed state, the plane row of each slot
    (``packed_layout.global_unpack_rows``)."""

    def __init__(self, trainer):
        lay = trainer.layout
        perm = np.asarray(lay.perm)
        valid = np.flatnonzero(perm >= 0)
        slot = np.empty(int(valid.size), dtype=np.int64)
        slot[perm[valid]] = valid
        self.n_pad = int(lay.n_pad)
        self.slot = slot                      # node -> blocked slot
        self.part = slot // self.n_pad        # node -> community
        self.plane_row = None
        if trainer.packed_layout is not None:
            gup = np.asarray(trainer.packed_layout.global_unpack_rows())
            self.plane_row = gup[slot]        # node -> plane row

    def state_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C) of a full state leaf: a packed plane or a blocked
        (M, n_pad, C) stack."""
        if self.plane_row is not None:
            idx = torch.as_tensor(self.plane_row, device=x.device)
            return x[idx]
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        return flat[torch.as_tensor(self.slot, device=x.device)]

    def blocked_rows(self, x: torch.Tensor, lanes: "list | None" = None
                     ) -> tuple[np.ndarray, torch.Tensor]:
        """(node ids, their rows) of a blocked (k, n_pad, C) output whose
        lanes are the communities ``lanes`` (default: all, in order)."""
        k = x.shape[0]
        lanes = list(range(k)) if lanes is None else list(lanes)
        nodes, rows = [], []
        for i, c in enumerate(lanes):
            ids = np.flatnonzero(self.part == c)
            nodes.append(ids)
            rows.append(i * self.n_pad + self.slot[ids] % self.n_pad)
        nodes = np.concatenate(nodes)
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        return nodes, flat[torch.as_tensor(np.concatenate(rows),
                                           device=x.device)]

    def state(self, st) -> dict:
        """A trainer state as host tensors in node order."""
        return {"weights": [w.detach().cpu().clone() for w in st.weights],
                "zs": [self.state_rows(z).cpu() for z in st.zs],
                "u": self.state_rows(st.u).cpu(),
                "taus": [t.detach().cpu().clone() for t in st.taus],
                "thetas": [t.detach().cpu().clone() for t in st.thetas]}


# the launchers whose output is an aggregation Ã Z (the fused launcher's
# is (Ã Z) W, which check.agg_err has no reference for)
AGG_NAMES = ("community_spmm_ell", "community_spmm_ell_packed")


@contextlib.contextmanager
def capture_aggregations(sink: list, keep=None):
    """While open, every aggregation the trainer launches appends
    (launcher name, its output) to ``sink``; the launchers are the
    program's own, called unchanged.  ``keep`` (say a copy to the host)
    is applied to the output before it is kept, so that the sink need not
    hold the card's tensors alive past the program's own use of them."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in AGG_NAMES}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append((name, out if keep is None else keep(out)))
            return out
        return call

    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield sink
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def launch_counts() -> dict:
    """The aggregation kernels' launch counters."""
    from repro_torch.kernels import community_spmm as cs
    return {"ell": cs.launches, "packed": cs.packed_launches,
            "fused": cs.fused_launches, "dense": cs.dense_launches}
