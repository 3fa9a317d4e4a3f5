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
``torchrun`` started — each rank holds its slices of the parameters by
``param_specs`` (``Model.init(mesh=...)``; the Adam state follows them,
``opt_state_specs``), places its rows of every global batch
(``TokenPipeline(mesh=...)``) and steps with ``Model.train_step_deferred``
under ``sharding_hints(mesh, moe_a2a=True)``: split over ``model``
(tensor-parallel), one reduction over the data axes after the
microbatches.  The reference's launcher jits ``train_step`` under its mesh
and lets XLA split it and insert the reductions; the port has no XLA, so
it runs the explicit form of that step.  Checkpoints are written whole by
rank 0 in the reference's format (the slices gathered), and ``--resume``
places the latest one again by the specs.  Rank 0 prints, with the bytes
each step moves along ``model``.
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
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--production-mesh", action="store_true",
                    help="join the 16 x 16 mesh of 256 ranks a launcher "
                         "such as torchrun started (from its environment)")
    ap.add_argument("--processes", type=int, default=1,
                    help="start this many ranks here (train_step_deferred "
                         "over them)")
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
    import contextlib

    from repro_torch.core.messages import MeshCollectives
    from repro_torch.sharding import hints, partition
    model = make_model(cfg)
    ranks = isinstance(mesh, mesh_lib.ProcessMesh)
    lead = not ranks or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.device if ranks else mesh.devices[0]
    how = f"; processes {mesh.world_size} ({mesh.backend}), " \
        f"train_step_deferred" if ranks else ""
    say(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
        f"mesh={dict(mesh.shape)}{how}")

    params = model.init(seed=args.seed, device=dev,
                        mesh=mesh if ranks else None)
    opt_state = model.init_optimizer().init(params)
    comm = MeshCollectives(mesh) if ranks else None
    specs = None
    if ranks:
        specs = {"params": model.param_specs(mesh),
                 "opt": model.opt_state_specs(mesh, opt_state)}
        say(f"[train] parameters placed by param_specs: "
            f"{_nbytes(params) / 1e6:.1f} MB a rank "
            f"(rank 0), Adam state {_nbytes(opt_state) / 1e6:.1f} MB")
    start = 0
    if args.resume:
        step0 = ckpt_lib.latest_step(args.ckpt_dir)
        state = ckpt_lib.restore(args.ckpt_dir,
                                 {"params": params, "opt": opt_state},
                                 step=step0, specs=specs,
                                 mesh=mesh if ranks else None)
        params, opt_state = state["params"], state["opt"]
        start = step0 + 1
        say(f"[train] resumed from step {step0}")
    source = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                     seed=args.seed)
    for _ in range(start):          # the batches the checkpoint has seen
        next(source)
    pipeline = TokenPipeline(source, device=dev,
                             mesh=mesh if ranks else None)

    context = hints.sharding_hints(mesh, moe_a2a=True, comm=comm) \
        if ranks else contextlib.nullcontext()
    losses, step_s, model_bytes = [], [], []
    t0 = last = time.perf_counter()
    with context:
        for step in range(start, start + args.steps):
            batch = next(pipeline)
            before = comm.model_bytes if ranks else 0
            if ranks:
                params, opt_state, metrics = model.train_step_deferred(
                    mesh, params, opt_state, batch, comm=comm)
            else:
                params, opt_state, metrics = model.train_step(
                    params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            now = time.perf_counter()
            step_s.append(now - last)
            last = now
            along = ""
            if ranks:
                model_bytes.append(comm.model_bytes - before)
                along = f", {model_bytes[-1] / 1e6:.1f} MB along model"
            if step % args.log_every == 0 or step == start + args.steps - 1:
                say(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                    f"({now - t0:.1f}s elapsed{along})")
            if args.ckpt_dir and args.ckpt_every and \
                    step % args.ckpt_every == args.ckpt_every - 1:
                state = {"params": params, "opt": opt_state}
                if ranks:           # every rank joins the gathers
                    state = partition.gather(state, specs, mesh, comm)
                if lead:
                    path = ckpt_lib.save(args.ckpt_dir, state, step=step)
                    say(f"[train] checkpoint -> {path}")
                del state
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
        say(f"[train] along model ({comm.model.world_size} ranks): "
            f"{comm.model_bytes / 1e6:.1f} MB sent in {args.steps} steps, "
            f"{1e3 * comm.model_s:.1f} ms of host time (rank 0)")
        return {"losses": losses, "step_s": step_s,
                "sum_bytes": comm.sum_bytes, "sum_s": comm.sum_s,
                "staging_s": comm.staging_s, "mesh": dict(mesh.shape),
                "model_bytes": model_bytes, "model_s": comm.model_s,
                "param_bytes": _nbytes(params),
                "opt_bytes": _nbytes(opt_state)}
    return {"losses": losses, "step_s": step_s, "model": model,
            "params": params, "opt_state": opt_state}


def _nbytes(tree_) -> int:
    from repro_torch.util import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(tree_))


if __name__ == "__main__":
    main()
