"""Training launcher, the port of src/repro/launch/train.py:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --steps 100 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --processes 2 --backend gloo --device cpu
  torchrun --nproc-per-node 8 ... -m repro_torch.launch.train \\
      --arch gemma-2b --production-mesh     # a world of 256 ranks

Trains with the config's optimizer, gradient accumulation and remat, on
synthetic token batches through ``TokenPipeline``; prints the reference's
lines and checkpoints ``{"params", "opt"}`` every ``--ckpt-every`` steps in
its format.  On one device (the card unless ``--device`` says otherwise)
each step is ``Model.train_step``.

Over a mesh of ranks — ``--processes N`` started here (``--model-axis M``
makes it ``data`` N/M × ``model`` M; ``--backend nccl`` needs a card per
rank, ``gloo`` shares a card or runs on the CPU), or ``--production-mesh``,
the reference's 16 × 16 over 256 ranks that a launcher such as
``torchrun`` started — each rank places its rows of every global batch
(``TokenPipeline(mesh=...)``) and steps with ``Model.train_step_deferred``.
The reference's launcher jits ``train_step`` under its mesh and lets XLA
insert the data-parallel gradient reduction; the port has no XLA, so it
runs the explicit form of that step: each rank's microbatches summed, then
one reduction over the data axes.  Rank 0 prints and writes the
checkpoints; every rank holds the same parameters.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, synthetic_token_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.build import make_model


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="join the 16 x 16 mesh of 256 ranks a launcher "
                         "such as torchrun started (from its environment)")
    ap.add_argument("--processes", type=int, default=1,
                    help="start this many ranks here (data-parallel "
                         "train_step_deferred over them)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis over --processes ranks")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' torch.distributed backend (default: "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the run: ``losses`` and ``step_s`` (host seconds from one
    step's loss read to the next's) per step; on one device also the
    trained ``model``, ``params`` and ``opt_state`` (over ranks, rank 0's
    record: the losses, step times and the bytes reduced a step)."""
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encoder_decoder or cfg.arch_type == "vlm":
        raise SystemExit(
            f"{args.arch}: use the examples/ scripts for multimodal batches")
    if args.production_mesh:
        mesh = mesh_lib.make_production_mesh(backend=args.backend)
        try:
            return run(args, cfg, mesh)
        finally:
            mesh_lib.destroy(mesh)
    if args.processes > 1:
        return spawn(args)
    return run(args, cfg, mesh_lib.make_host_mesh(args.device))


def spawn(args) -> dict:
    """``--processes N``: N ranks from ``torch.multiprocessing`` (spawn), a
    file store in a temporary directory; returns rank 0's record."""
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    backend = args.backend or ("gloo" if on_cpu else "nccl")
    mesh_lib.check_backend(backend, args.processes, args.device)
    if args.processes % args.model_axis:
        raise ValueError(f"--model-axis {args.model_axis} does not divide "
                         f"--processes {args.processes}")
    with tempfile.TemporaryDirectory(prefix="train_") as tmp:
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
        mesh = mesh_lib.make_rank_mesh(base, args.model_axis)
        cfg = get_config(args.arch, reduced=args.reduced)
        log = run(args, cfg, mesh)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(log, f)
    finally:
        mesh_lib.destroy(base)


def run(args, cfg, mesh) -> dict:
    """Train on ``mesh`` (one device, or this rank of a mesh of ranks)."""
    from repro_torch.core.messages import MeshCollectives
    model = make_model(cfg)
    ranks = isinstance(mesh, mesh_lib.ProcessMesh)
    lead = not ranks or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.device if ranks else mesh.devices[0]
    how = f"; processes {mesh.world_size} ({mesh.backend}), " \
        f"train_step_deferred" if ranks else ""
    say(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
        f"mesh={dict(mesh.shape)}{how}")

    source = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                     seed=args.seed)
    pipeline = TokenPipeline(source, device=dev,
                             mesh=mesh if ranks else None)

    params = model.init(seed=args.seed, device=dev)
    opt_state = model.init_optimizer().init(params)
    comm = MeshCollectives(mesh) if ranks else None

    losses, step_s = [], []
    t0 = last = time.perf_counter()
    for step in range(args.steps):
        batch = next(pipeline)
        if ranks:
            params, opt_state, metrics = model.train_step_deferred(
                mesh, params, opt_state, batch, comm=comm)
        else:
            params, opt_state, metrics = model.train_step(params, opt_state,
                                                          batch)
        losses.append(float(metrics["loss"]))
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                f"({now - t0:.1f}s elapsed)")
        if lead and args.ckpt_dir and args.ckpt_every and \
                step % args.ckpt_every == args.ckpt_every - 1:
            path = ckpt_lib.save(args.ckpt_dir,
                                 {"params": params, "opt": opt_state},
                                 step=step)
            say(f"[train] checkpoint -> {path}")
            last = time.perf_counter()

    first = np.mean(losses[:5])
    final = np.mean(losses[-5:])
    say(f"[train] loss {first:.4f} -> {final:.4f} "
        f"({'improved' if final < first else 'NOT improved'})")
    if ranks:
        say(f"[train] data-parallel reduction: {comm.sum_bytes / 1e6:.1f} MB "
            f"summed over {comm.data.world_size} data ranks in "
            f"{args.steps} steps, {1e3 * comm.sum_s:.1f} ms of host time, of "
            f"it staging {1e3 * comm.staging_s:.1f} ms (rank 0)")
        return {"losses": losses, "step_s": step_s,
                "sum_bytes": comm.sum_bytes, "sum_s": comm.sum_s,
                "staging_s": comm.staging_s, "mesh": dict(mesh.shape)}
    return {"losses": losses, "step_s": step_s, "model": model,
            "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
