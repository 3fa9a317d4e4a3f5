"""Layerwise (blockwise) ADMM training of a transformer, then Adam on the
same fixed batch: the port of examples/train_transformer_admm.py.

  PYTHONPATH=src python -m repro_torch.launch.train_admm \\
      --arch qwen2-7b --iters 10 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train_admm \\
      --arch qwen2-7b --processes 4 --model-axis 2 --backend gloo \\
      --device cpu

Reduced configs, as the reference's example; every segment's layers are
ADMM blocks (``core.layerwise``), the readout a gradient step.  Runs on the
card unless ``--device`` says otherwise.  ``--processes N`` runs the
trainer over a ``data`` N/M × ``model`` M mesh of ranks (``--model-axis
M``: the blocks over ``model``, the batch rows over ``data``;
``--backend nccl`` needs a card per rank, ``gloo`` shares one or runs on
the CPU); rank 0 prints, and runs the Adam comparison alone.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.layerwise import LayerwiseADMMTrainer
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.build import make_model
from repro_torch.util.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--nu", type=float, default=1e-2)
    ap.add_argument("--rho", type=float, default=1e-2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--processes", type=int, default=1,
                    help="run the trainer over this many ranks")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis over --processes ranks")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' torch.distributed backend (default: "
                         "nccl on the card, gloo on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the CE after each logged ADMM iteration (``admm_ce``) and
    Adam's last CE (``adam_ce``); over ranks, rank 0's."""
    args = parse_args(argv)
    if args.processes > 1:
        return spawn(args)
    return run(args)


def spawn(args) -> dict:
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    backend = args.backend or ("gloo" if on_cpu else "nccl")
    mesh_lib.check_backend(backend, args.processes, args.device)
    if args.processes % args.model_axis:
        raise ValueError(f"--model-axis {args.model_axis} does not divide "
                         f"--processes {args.processes}")
    with tempfile.TemporaryDirectory(prefix="train_admm_") as tmp:
        out = os.path.join(tmp, "log.json")
        mesh_lib.run_ranks(_rank, args.processes, (args, backend, out))
        with open(out) as f:
            return json.load(f)


def _rank(rank: int, store: str, args, backend: str, out: str) -> None:
    if args.device is not None and torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.processes))
    base = mesh_lib.init_process_mesh(rank, args.processes, backend, store,
                                      device=args.device)
    try:
        log = run(args, mesh_lib.make_rank_mesh(base, args.model_axis))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(log, f)
    finally:
        mesh_lib.destroy(base)


def run(args, mesh=None) -> dict:
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    cfg = get_config(args.arch, reduced=True)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32),
            device=dev),
        "targets": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32),
            device=dev),
    }
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.as_tensor(rng.normal(size=(
            args.batch, cfg.frontend.num_embeddings,
            cfg.d_model)).astype(np.float32), device=dev)

    trainer = LayerwiseADMMTrainer(cfg, ADMMConfig(nu=args.nu, rho=args.rho),
                                   mesh=mesh)
    state, z0 = trainer.init(0, batch, dev)
    if mesh is not None:
        say(f"[admm] mesh={dict(mesh.shape)}; processes {mesh.world_size} "
            f"({mesh.backend}); rank 0 holds blocks "
            f"{[(s.kind, lo, hi) for s, lo, hi, _ in trainer.local]}")

    ce, res = trainer.metrics(state, z0, batch["targets"])
    say(f"[admm] init     ce {float(ce):.4f} residual {float(res):.2e}")
    admm_ce = []
    for i in range(args.iters):
        state = trainer.iteration(state, z0, batch["targets"])
        if (i + 1) % 2 == 0 or i == args.iters - 1:
            ce, res = trainer.metrics(state, z0, batch["targets"])
            admm_ce.append(float(ce))
            say(f"[admm] iter {i + 1:3d} ce {float(ce):.4f} "
                f"residual {float(res):.2e}")
    out = {"admm_ce": admm_ce}
    if mesh is not None:
        c = trainer.comm
        say(f"[admm] rank 0: summed {c.sum_bytes / 1e6:.2f} MB over data, "
            f"sent {c.sent_bytes / 1e6:.2f} MB along model")
        out.update(sum_bytes=c.sum_bytes, sent_bytes=c.sent_bytes)
    if not lead:
        return out

    # Adam reference on the same batch
    model = make_model(cfg)
    params = model.init(0, dev)
    opt_state = model.init_optimizer().init(params)
    for _ in range(args.iters):
        params, opt_state, m = model.train_step(params, opt_state, batch)
    say(f"[adam] {args.iters} steps -> ce {float(m['ce']):.4f}")
    out["adam_ce"] = float(m["ce"])
    return out


if __name__ == "__main__":
    main()
