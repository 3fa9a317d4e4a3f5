"""Training launcher, the port of src/repro/launch/train.py:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --steps 100 [--device cpu]

Trains on one device (the card unless ``--device`` says otherwise) with
the config's optimizer, gradient accumulation and remat, on synthetic
token batches through ``TokenPipeline``; prints the reference's lines and
checkpoints ``{"params", "opt"}`` every ``--ckpt-every`` steps in its
format.  ``--production-mesh`` (many devices) is ROADMAP queue A item 5.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

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
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the run: ``losses`` and ``step_s`` (host seconds from one
    step's loss read to the next's) per step, and the trained ``model``,
    ``params`` and ``opt_state``."""
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encoder_decoder or cfg.arch_type == "vlm":
        raise SystemExit(
            f"{args.arch}: use the examples/ scripts for multimodal batches")
    model = make_model(cfg)

    mesh = mesh_lib.make_production_mesh() if args.production_mesh \
        else mesh_lib.make_host_mesh(args.device)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"mesh={dict(mesh.shape)}")

    source = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                     seed=args.seed)
    pipeline = TokenPipeline(source, device=mesh.devices[0])

    params = model.init(seed=args.seed, device=mesh.devices[0])
    opt_state = model.init_optimizer().init(params)

    losses, step_s = [], []
    t0 = last = time.perf_counter()
    for step in range(args.steps):
        batch = next(pipeline)
        params, opt_state, metrics = model.train_step(params, opt_state,
                                                      batch)
        losses.append(float(metrics["loss"]))
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"({now - t0:.1f}s elapsed)")
        if args.ckpt_dir and args.ckpt_every and \
                step % args.ckpt_every == args.ckpt_every - 1:
            path = ckpt_lib.save(args.ckpt_dir,
                                 {"params": params, "opt": opt_state},
                                 step=step)
            print(f"[train] checkpoint -> {path}")
            last = time.perf_counter()

    first = np.mean(losses[:5])
    final = np.mean(losses[-5:])
    print(f"[train] loss {first:.4f} -> {final:.4f} "
          f"({'improved' if final < first else 'NOT improved'})")
    return {"losses": losses, "step_s": step_s, "model": model,
            "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
