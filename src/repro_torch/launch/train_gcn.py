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

``--processes N`` runs each shard in a process of its own (N ranks of a
``torch.distributed`` group, rank r on card r mod the cards), which
exchange neighbour rows through the process transport: ``--backend nccl``
needs a card per rank; ``--backend gloo`` runs several ranks on one card
(rows staged through the host) or on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train_gcn \
      --dataset amazon_computers --parts 4 --shards 4 --processes 4 \
      --backend nccl --compressed --packed --use-kernel --hidden 1000 \
      --epochs 3
  PYTHONPATH=src python -m repro_torch.launch.train_gcn --parts 4 \
      --processes 4 --backend gloo --compressed --packed --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core import gcn, graph
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch import mesh as mesh_lib


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
                         "otherwise); between logical shards of one device "
                         "each round is a row copy, with --processes the "
                         "rows cross between the ranks (torch.distributed)")
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
    ap.add_argument("--processes", type=int, default=1,
                    help="one process per shard: N ranks of a "
                         "torch.distributed group (sets --shards N), which "
                         "exchange neighbour rows through the process "
                         "transport")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' torch.distributed backend (default: "
                         "nccl on the card, gloo on the CPU); nccl needs a "
                         "card per rank, gloo shares one or runs on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="on the card, one more step under torch.profiler "
                         "and the span log (rank 0's under --processes): "
                         "its wall ms, device busy ms and idle share, its "
                         "host ms by phase and its host reads")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    return ap.parse_args(argv)


def profiled_step(trainer) -> tuple[float, float, float, int,
                                    trace.SpanLog]:
    """(wall ms, device-busy ms, device ms of the NCCL kernels, their
    count, the span log) of one ``trainer.step()`` on the card: busy is
    the union of the device intervals the profiler traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = trainer.device
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            trace.spans() as log:
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    # gloo's point-to-point waits are filed with the device events, but
    # no kernel runs in them
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("gloo:")]
    busy, end = 0.0, -float("inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    nccl = [e.time_range.end - e.time_range.start for e in events
            if "nccl" in e.name.lower()]
    return 1e3 * wall, busy / 1e3, sum(nccl) / 1e3, len(nccl), log


def phase_line(log: trace.SpanLog) -> str:
    """A step's host ms by phase span (``admm.*``, ``comm.*``; a span
    that repeats with its count), the Z_L prox's route (``fista.kernel``
    / ``fista.plain`` steps) and its host reads, from its span log."""
    parts = []
    for name, row in log.summary().items():
        if name.startswith(("admm.", "comm.")):
            n = f" x{row['count']}" if row["count"] > 1 else ""
            parts.append(f"{name} {1e3 * row['host_s']:.2f}{n}")
    return (f"phases (host ms): {', '.join(parts)}; Z_L prox kernel / "
            f"plain {log.total('fista.kernel')} / "
            f"{log.total('fista.plain')}; host reads "
            f"{log.total('host_reads')}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.processes > 1:
        return spawn(args)
    return run(args)


def spawn(args) -> dict:
    """``--processes N``: N ranks from ``torch.multiprocessing`` (spawn),
    a file store in a temporary directory; the CUDA libraries built here
    once, before the ranks start.  Raises (the CLI exits nonzero) if any
    rank fails; returns rank 0's log."""
    if args.shards not in (1, args.processes):
        raise ValueError(f"--shards {args.shards} disagrees with "
                         f"--processes {args.processes}")
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    backend = args.backend or ("gloo" if on_cpu else "nccl")
    mesh_lib.check_backend(backend, args.processes, args.device)
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu --backend gloo to run on the CPU")
        if args.use_kernel:
            from repro_torch.kernels import build
            build.load_all(["community_spmm_ell",
                            "community_spmm_ell_fused"])
    with tempfile.TemporaryDirectory(prefix="train_gcn_") as tmp:
        out = os.path.join(tmp, "log.json")
        mesh_lib.run_ranks(_rank, args.processes, (args, backend, out))
        with open(out) as f:
            return json.load(f)


def _rank(rank: int, store: str, args, backend: str, out: str) -> None:
    if args.device is not None and torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.processes))
    mesh = mesh_lib.init_process_mesh(rank, args.processes, backend, store,
                                      device=args.device)
    try:
        log = run(args, mesh)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(log, f)
    finally:
        mesh_lib.destroy(mesh)


def run(args, mesh=None) -> dict:
    """Train and print (rank 0 prints under a mesh)."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    g = graph.synthetic_sbm(args.dataset, seed=0)
    hyper = 1e-3 if "computers" in args.dataset else 1e-4
    cfg = gcn.GCNConfig(layer_dims=(g.features.shape[1], args.hidden,
                                    g.num_classes))
    admm = ADMMConfig(nu=hyper, rho=hyper)

    part = graph.partition_graph(g.num_nodes, g.edges, args.parts, seed=0,
                                 method=args.partitioner)
    q = graph.partition_quality(g.num_nodes, g.edges, part, args.parts)
    say(f"partition [{args.partitioner}]: {args.parts} communities, sizes "
          f"{np.bincount(part).tolist()}, edge cut "
          f"{q['edge_cut']}/{g.num_edges} ({100 * q['cut_frac']:.1f}%), "
          f"balance {q['balance']:.3f}, block max_deg {q['max_deg']}")

    trainer = ParallelADMMTrainer(cfg, admm, g, num_parts=args.parts,
                                  seed=0, part=part, device=args.device,
                                  config=TrainerConfig.from_cli_args(args),
                                  n_shards=args.shards, mesh=mesh)
    cs = trainer.comm_stats
    say(f"device: {trainer.device}; layout n_pad={trainer.layout.n_pad}, "
        f"row counts {trainer.layout.eff_row_counts().tolist()}")
    procs = "" if mesh is None else \
        f"; processes {mesh.world_size} ({mesh.backend})"
    say(f"shards: {trainer.n_shards} [{cs['transport']}]{procs}, wire "
        f"{cs['wire_bytes'] / 1e6:.3f} MB per step (all-gather "
        f"{cs['full_bytes'] / 1e6:.3f} MB); fused {args.fused}, overlap "
        f"{args.overlap}, bf16 wire {args.comm_bf16}, batch fraction "
        f"{args.batch_fraction}")
    adj = cs["adjacency"]
    mode = "compressed (ELL"
    mode += ", bf16 blocks)" if args.adjacency_bf16 else ")"
    mode = mode if args.compressed else "dense"
    say(f"adjacency on device [{mode}]: {adj['resident_bytes'] / 1e6:.2f} "
        f"MB (dense would be {adj['dense_bytes'] / 1e6:.2f} MB, max_deg "
        f"{adj['max_deg']})")
    st = cs["state"]
    say(f"resident state [{'packed' if st['packed'] else 'strided'}]: "
        f"{st['rows']} rows / {st['resident_bytes'] / 1e6:.2f} MB "
        f"(strided {st['strided_rows']} rows)")

    log = trainer.train(args.epochs, verbose=False)
    stride = max(1, args.epochs // 10)
    for i in range(0, len(log.epoch), stride):
        say(f"epoch {log.epoch[i]:4d} train {log.train_acc[i]:.3f} "
            f"test {log.test_acc[i]:.3f} lagr {log.lagrangian[i]:.4f} "
            f"residual {log.residual[i]:.2e} "
            f"step {1e3 * log.epoch_time_s[i]:.1f} ms")
    if mesh is not None:
        cs = trainer.comm_stats
        say(f"processes: sent {cs['sent_bytes'] / 1e6:.3f} MB in the last "
            f"step (by rank {cs['rank_sent_bytes']}; the plan's wire "
            f"{cs['wire_bytes'] / 1e6:.3f} MB); rank 0 transport "
            f"{1e3 * cs['transport_s']:.1f} ms, of it host staging "
            f"{1e3 * cs['staging_s']:.1f} ms")
        if "overlap" in cs:
            ov = cs["overlap"]
            say(f"overlap model ({ov['model']['ici_bw'] / 1e9:g} GB/s a "
                f"link, {ov['model']['peak_flops'] / 1e12:g} TFLOP/s): wire "
                f"{1e3 * ov['total_wire_s']:.3f} ms a step over "
                f"{ov['num_rounds']} rounds x {ov['num_gathers']} gathers, "
                f"exposed {1e3 * ov['exposed_wire_s']:.3f} ms; measured "
                f"rank 0 transport {1e3 * cs['transport_s']:.1f} ms")
    if args.profile and trainer.device.type == "cuda":
        if mesh is None or mesh.rank == 0:
            wall, busy, nccl_ms, nccl_n, spans = profiled_step(trainer)
            say(f"profiled step: wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms, device idle share {1 - busy / wall:.4f}; "
                f"NCCL kernels {nccl_ms:.3f} ms in {nccl_n} events")
            say(phase_line(spans))
        else:
            trainer.step()
    say(f"final: train {log.train_acc[-1]:.3f} test {log.test_acc[-1]:.3f}")
    return log.as_dict()


if __name__ == "__main__":
    main()
