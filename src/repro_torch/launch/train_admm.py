"""Layerwise (blockwise) ADMM training of a transformer, then Adam on the
same fixed batch: the port of examples/train_transformer_admm.py.

  PYTHONPATH=src python -m repro_torch.launch.train_admm \\
      --arch qwen2-7b --iters 10 [--device cpu]

Reduced configs, as the reference's example; every segment's layers are
ADMM blocks (``core.layerwise``), the readout a gradient step.  Runs on the
card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.layerwise import LayerwiseADMMTrainer
from repro_torch.core.subproblems import ADMMConfig
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
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the CE after each logged ADMM iteration (``admm_ce``) and
    Adam's last CE (``adam_ce``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
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

    trainer = LayerwiseADMMTrainer(cfg, ADMMConfig(nu=args.nu, rho=args.rho))
    state, z0 = trainer.init(0, batch, dev)

    ce, res = trainer.metrics(state, z0, batch["targets"])
    print(f"[admm] init     ce {float(ce):.4f} residual {float(res):.2e}")
    admm_ce = []
    for i in range(args.iters):
        state = trainer.iteration(state, z0, batch["targets"])
        if (i + 1) % 2 == 0 or i == args.iters - 1:
            ce, res = trainer.metrics(state, z0, batch["targets"])
            admm_ce.append(float(ce))
            print(f"[admm] iter {i + 1:3d} ce {float(ce):.4f} "
                  f"residual {float(res):.2e}")

    # Adam reference on the same batch
    model = make_model(cfg)
    params = model.init(0, dev)
    opt_state = model.init_optimizer().init(params)
    for _ in range(args.iters):
        params, opt_state, m = model.train_step(params, opt_state, batch)
    print(f"[adam] {args.iters} steps -> ce {float(m['ce']):.4f}")
    return {"admm_ce": admm_ce, "adam_ce": float(m["ce"])}


if __name__ == "__main__":
    main()
