"""Command-line entry point of the port's Parallel ADMM GCN trainer.

The counterpart of examples/train_gcn_communities.py.  On the card, dense
adjacency (the default) through the dense CUDA kernel, or block-compressed
ELL adjacency with packed state through the ELL kernel:

  PYTHONPATH=src python -m repro_torch.launch.train_gcn \\
      --dataset amazon_computers --parts 3 --hidden 1000 --epochs 3 \\
      --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.train_gcn \\
      --dataset amazon_computers --parts 3 --hidden 1000 --epochs 3 \\
      --compressed --packed --use-kernel [--adjacency-bf16]

Add ``--device cpu`` to run on the CPU (the CUDA kernels' plain versions
then do the aggregation).  ``--shards N`` runs the communities over N
logical shards of the device, which exchange neighbour rows through the
loopback transport; with ``--packed`` the packed and fused kernels do the
aggregation:

  PYTHONPATH=src python -m repro_torch.launch.train_gcn --parts 4 \
      --shards 4 --compressed --packed [--fused] [--overlap] \
      [--comm-bf16] [--batch-fraction 0.5] --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import gcn, graph
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="amazon_photo_mini",
                    choices=list(graph.DATASET_STATS))
    ap.add_argument("--parts", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--compressed", action="store_true",
                    help="block-compressed (ELL) adjacency: only the "
                         "neighbour blocks on the device, no dense "
                         "(M, M, n_pad, n_pad) tensor")
    ap.add_argument("--use-kernel", action="store_true",
                    help="aggregate through the CUDA kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--transport", default=None,
                    choices=["p2p", "allgather"],
                    help="Z/U/q exchange: neighbour-only p2p (default with "
                         "--compressed) or the masked all-gather (default "
                         "otherwise); one device exchanges nothing, so "
                         "this sets the configuration and its accounting")
    ap.add_argument("--partitioner", default="multilevel",
                    choices=["bfs_kl", "multilevel"],
                    help="community detection: multilevel (METIS scheme) "
                         "or the BFS-grow + Kernighan-Lin stand-in")
    ap.add_argument("--pad-mode", default="bucketed",
                    choices=["global", "bucketed"],
                    help="one global n_pad or size-aware pad buckets")
    ap.add_argument("--adjacency-bf16", action="store_true",
                    help="store the ELL adjacency blocks in bf16 (half the "
                         "resident bytes; aggregation still accumulates "
                         "f32) — requires --compressed")
    ap.add_argument("--packed", action="store_true",
                    help="store Z/U/z0 as packed Σ-bucket-rows planes "
                         "(requires --compressed)")
    ap.add_argument("--overlap", action="store_true",
                    help="split each aggregation by the exchange round "
                         "that delivered its rows (requires --packed)")
    ap.add_argument("--fused", action="store_true",
                    help="the four Z-update aggregation→GEMM sites through "
                         "the fused kernel (requires --packed)")
    ap.add_argument("--comm-bf16", action="store_true",
                    help="bf16 payloads on the wire (rounded where they "
                         "cross between shards)")
    ap.add_argument("--batch-fraction", type=float, default=None,
                    help="community minibatching: sample this fraction of "
                         "the shards each round (requires --packed)")
    ap.add_argument("--shards", type=int, default=1,
                    help="logical shards on the one device (must divide "
                         "--parts); above 1 the shards exchange neighbour "
                         "rows through the loopback transport")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    g = graph.synthetic_sbm(args.dataset, seed=0)
    hyper = 1e-3 if "computers" in args.dataset else 1e-4
    cfg = gcn.GCNConfig(layer_dims=(g.features.shape[1], args.hidden,
                                    g.num_classes))
    admm = ADMMConfig(nu=hyper, rho=hyper)

    part = graph.partition_graph(g.num_nodes, g.edges, args.parts, seed=0,
                                 method=args.partitioner)
    q = graph.partition_quality(g.num_nodes, g.edges, part, args.parts)
    print(f"partition [{args.partitioner}]: {args.parts} communities, sizes "
          f"{np.bincount(part).tolist()}, edge cut "
          f"{q['edge_cut']}/{g.num_edges} ({100 * q['cut_frac']:.1f}%), "
          f"balance {q['balance']:.3f}, block max_deg {q['max_deg']}")

    trainer = ParallelADMMTrainer(cfg, admm, g, num_parts=args.parts,
                                  seed=0, part=part, device=args.device,
                                  config=TrainerConfig.from_cli_args(args),
                                  n_shards=args.shards)
    cs = trainer.comm_stats
    print(f"device: {trainer.device}; layout n_pad={trainer.layout.n_pad}, "
          f"row counts {trainer.layout.eff_row_counts().tolist()}")
    print(f"shards: {trainer.n_shards} [{cs['transport']}], wire "
          f"{cs['wire_bytes'] / 1e6:.3f} MB per step (all-gather "
          f"{cs['full_bytes'] / 1e6:.3f} MB); fused {args.fused}, overlap "
          f"{args.overlap}, bf16 wire {args.comm_bf16}, batch fraction "
          f"{args.batch_fraction}")
    adj = cs["adjacency"]
    mode = "compressed (ELL"
    mode += ", bf16 blocks)" if args.adjacency_bf16 else ")"
    mode = mode if args.compressed else "dense"
    print(f"adjacency on device [{mode}]: {adj['resident_bytes'] / 1e6:.2f} "
          f"MB (dense would be {adj['dense_bytes'] / 1e6:.2f} MB, max_deg "
          f"{adj['max_deg']})")
    st = cs["state"]
    print(f"resident state [{'packed' if st['packed'] else 'strided'}]: "
          f"{st['rows']} rows / {st['resident_bytes'] / 1e6:.2f} MB "
          f"(strided {st['strided_rows']} rows)")

    log = trainer.train(args.epochs, verbose=False)
    stride = max(1, args.epochs // 10)
    for i in range(0, len(log.epoch), stride):
        print(f"epoch {log.epoch[i]:4d} train {log.train_acc[i]:.3f} "
              f"test {log.test_acc[i]:.3f} lagr {log.lagrangian[i]:.4f} "
              f"residual {log.residual[i]:.2e} "
              f"step {1e3 * log.epoch_time_s[i]:.1f} ms")
    print(f"final: train {log.train_acc[-1]:.3f} test {log.test_acc[-1]:.3f}")
    return log.as_dict()


if __name__ == "__main__":
    main()
