"""Serving launcher: cached community-block GCN inference.

The port of ``repro.launch.serve``, with the same flags and defaults plus
``--device``.  Trains a small community-partitioned GCN (the power-law
benchmark family), stands up a ``repro_torch.serve.CommunityServer`` over
the trained weights, and drives a Zipf request stream through the batched
serving path, printing steady-state latency percentiles, QPS and cache hit
rate.  ``--update`` then applies a feature update mid-stream to show
incremental invalidation: only the read closure of the touched communities
recomputes.  On the card (the default device):

    PYTHONPATH=src python -m repro_torch.launch.serve --parts 16 --epochs 3
    PYTHONPATH=src python -m repro_torch.launch.serve --no-cache   # baseline

Add ``--device cpu`` to run on the CPU (the kernels' plain versions then
do the aggregation).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _percentile_ms(times: list, q: float) -> float:
    return float(np.percentile(np.asarray(times) * 1e3, q))


def _drive(server, stream: np.ndarray, batch: int) -> dict:
    n_batches = len(stream) // batch
    warmup = max(n_batches // 4, 1)
    times = []
    h0 = t0 = 0
    for i in range(n_batches):
        if i == warmup:
            h0, t0 = server.request_hits, server.request_total
        tic = time.perf_counter()
        server.serve(stream[i * batch:(i + 1) * batch])
        if i >= warmup:
            times.append(time.perf_counter() - tic)
    hits = server.request_hits - h0
    total = server.request_total - t0
    return {"p50_ms": _percentile_ms(times, 50),
            "p99_ms": _percentile_ms(times, 99),
            "qps": len(times) * batch / max(sum(times), 1e-9),
            "hit_rate": hits / max(total, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cached community-block GCN serving demo")
    ap.add_argument("--parts", type=int, default=16, help="communities M")
    ap.add_argument("--nodes-per-part", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--zipf-s", type=float, default=1.1)
    ap.add_argument("--embed-capacity", type=int, default=None,
                    help="embedding-cache blocks (default: 1.25*M)")
    ap.add_argument("--halo-capacity", type=int, default=64)
    ap.add_argument("--admission", choices=("zipf", "lru"), default="zipf")
    ap.add_argument("--no-cache", action="store_true",
                    help="capacity-0 caches: every batch recomputes")
    ap.add_argument("--fused", action="store_true",
                    help="cold path through the fused agg→GEMM kernel")
    ap.add_argument("--update", type=int, default=0, metavar="K",
                    help="after the stream, update K node features and "
                         "report the invalidation footprint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from repro_torch.core import gcn, graph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.core.subproblems import ADMMConfig
    from repro_torch.serve import (CommunityServer, ServeConfig,
                                   zipf_node_stream)

    g, part = graph.synthetic_powerlaw_communities(
        args.parts, nodes_per_part=args.nodes_per_part, attach=2,
        seed=args.seed, feat_dim=16, size_skew=1.0)
    cfg = gcn.GCNConfig(layer_dims=(16, 32, g.num_classes))
    tr = ParallelADMMTrainer(
        cfg, ADMMConfig(nu=1e-3, rho=1e-3), g, num_parts=args.parts,
        seed=args.seed, part=part, device=args.device,
        config=TrainerConfig(transport="p2p", compressed=True,
                             pad_mode="bucketed", packed=True))
    print(f"[serve] training M={args.parts} model on N={g.num_nodes} "
          f"({args.epochs} epochs)...")
    tr.train(args.epochs)
    _, test_acc, _ = tr._metrics(tr.state)
    print(f"[serve] test_acc={float(test_acc):.4f}")

    ecap = args.embed_capacity
    if ecap is None:
        ecap = max(args.parts + args.parts // 4, 8)
    scfg = ServeConfig(embed_capacity=ecap,
                       halo_capacity=args.halo_capacity,
                       cache_enabled=not args.no_cache,
                       admission=args.admission, fused=args.fused,
                       max_batch=args.batch)
    server = CommunityServer.from_trainer(tr, scfg)

    stream = zipf_node_stream(g.num_nodes, args.requests, s=args.zipf_s,
                              seed=args.seed + 1)
    res = _drive(server, stream, args.batch)
    mode = "cold (cache disabled)" if args.no_cache else \
        f"cached (embed={ecap}, halo={args.halo_capacity}, " \
        f"admission={args.admission})"
    print(f"[serve] {mode}")
    print(f"[serve] Zipf(s={args.zipf_s}) x {args.requests} requests, "
          f"batch {args.batch}:")
    print(f"[serve]   p50 {res['p50_ms']:.3f} ms   p99 "
          f"{res['p99_ms']:.3f} ms   {res['qps']:.0f} qps   "
          f"hit rate {res['hit_rate']:.3f}")

    if args.update > 0:
        rng = np.random.default_rng(args.seed + 2)
        ids = rng.choice(g.num_nodes, size=args.update, replace=False)
        feats = np.asarray(g.features)[ids] + rng.normal(
            scale=0.1, size=(args.update, cfg.layer_dims[0])).astype(
            np.float32)
        rep = server.update_features(ids, feats)
        dirty = [len(c) for c in rep["dirty"]]
        print(f"[serve] updated {args.update} node feature row(s): "
              f"dirty communities per hop {dirty} of M={args.parts}; "
              f"dropped {len(rep['embed'])} embed / {len(rep['halo'])} "
              f"halo cache entries")
        res2 = _drive(server, stream, args.batch)
        print(f"[serve]   post-update p50 {res2['p50_ms']:.3f} ms   "
              f"hit rate {res2['hit_rate']:.3f} (recovered from cache)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
