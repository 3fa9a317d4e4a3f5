#!/usr/bin/env python3
"""Time mamba2-1.3b's prefill and training step over 1 x 2 gloo ranks
that share one card, for the tree whose ``src`` directory is given, so
that two commits' routes over ``model`` can be compared on the same card.

    python3 scripts/time_mesh_step.py [--src DIR] [--out FILE]
        [--reduced --cpu --seq 64]

``--src`` (default: this checkout's ``src``) is put first on the path, so
the ranks run that tree's ``repro_torch``; the script itself uses only
entry points that every tree since the tensor-parallel training step has:
``Model.init(mesh=)``, ``forward(last_only=True)`` under
``sharding_hints(mesh, moe_a2a=True)`` and ``train_step_deferred``.

Each rank draws its slices of the published config from seed 0, runs
three prefills of 2 x ``--seq`` (4,096) tokens through the kernels
(``use_kernel=True``; the first is a warm-up that builds them) and two
training steps of the config's Adam and ``grad_accum`` on one fixed
batch of the same size.  Each is timed on the host's clock
between card synchronisations, with the bytes that left the rank along
``model`` and the host seconds in those collectives; the prefills also
count the SSD and flash launches.  Rank 0 prints one JSON line with every
rank's record, the card's name and power limit (``nvidia-smi``), and
writes it to ``--out`` when given.  Compare two trees in one call on one
card, in the order parent, change, change, parent.  ``--reduced --cpu``
runs the reduced config on CPU ranks (the plain versions of the kernels):
a check of the script, not a measurement.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"
BATCH, MODEL_AXIS, PREFILLS, STEPS = 2, 2, 3, 2


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else "nvidia-smi failed"


def rank_main(rank: int, store: str, spec: dict) -> None:
    """One rank: its record to ``spec["dir"]/rank<r>.json``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.messages import MeshCollectives
    from repro_torch.data import synthetic_token_batches
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.sharding import hints

    world = MODEL_AXIS
    base = mesh_lib.init_process_mesh(rank, world, "gloo", store,
                                      device=spec["device"], timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, world)
        dev = mesh.device
        card = dev.type == "cuda"

        def sync():
            if card:
                torch.cuda.synchronize(dev)
        cfg = get_config(ARCH, reduced=spec["reduced"])
        model = make_model(cfg)
        params = model.init(seed=0, device=dev, mesh=mesh)
        b, s = BATCH, spec["seq"]
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        tokens = tokens.to(dev)
        rec: dict = {"device": str(dev), "prefill": [], "train": []}
        with hints.sharding_hints(mesh, moe_a2a=True) as comm, \
                torch.inference_mode():
            for _ in range(PREFILLS):
                c0 = (comm.model_bytes, comm.model_s, ssd_scan.ssd_launches,
                      flash_attention.flash_launches)
                sync()
                t0 = time.perf_counter()
                logits, _, _ = model.forward(params, {"tokens": tokens},
                                             use_kernel=True, last_only=True)
                sync()
                rec["prefill"].append({
                    "ms": 1e3 * (time.perf_counter() - t0),
                    "model_bytes": comm.model_bytes - c0[0],
                    "model_ms": 1e3 * (comm.model_s - c0[1]),
                    "ssd_launches": ssd_scan.ssd_launches - c0[2],
                    "flash_launches": flash_attention.flash_launches - c0[3],
                    "finite": bool(torch.isfinite(logits).all())})
                del logits
        batch = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=5))
        batch = {k: v[mesh_lib.batch_rows(mesh, b)]
                 for k, v in batch.items()}
        opt_state = model.init_optimizer().init(params)
        comm = MeshCollectives(mesh)
        with hints.sharding_hints(mesh, moe_a2a=True, comm=comm):
            for _ in range(STEPS):
                c0 = (comm.model_bytes, comm.model_s)
                sync()
                if card:
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                params, opt_state, met = model.train_step_deferred(
                    mesh, params, opt_state, batch, comm=comm)
                loss = float(met["loss"])
                sync()
                rec["train"].append({
                    "ms": 1e3 * (time.perf_counter() - t0), "loss": loss,
                    "model_bytes": comm.model_bytes - c0[0],
                    "model_ms": 1e3 * (comm.model_s - c0[1]),
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)
                    if card else None})
        (pathlib.Path(spec["dir"]) / f"rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (with --reduced: a check of the script)")
    args = ap.parse_args()
    src = str(pathlib.Path(args.src).resolve())
    sys.path.insert(0, src)        # the spawned ranks inherit the path
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="time_mesh_step_") as tmp:
        spec = {"seq": args.seq, "reduced": args.reduced,
                "device": "cpu" if args.cpu else None, "dir": tmp}
        mesh_lib.run_ranks(rank_main, MODEL_AXIS, (spec,), timeout=1800)
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json")
                            .read_text()) for r in range(MODEL_AXIS)]
    out = {"src": src, "card": "cpu" if args.cpu else card_line(),
           "wall_s": time.perf_counter() - t0, "arch": ARCH,
           "batch": BATCH, "seq": args.seq, "model_axis": MODEL_AXIS,
           "reduced": args.reduced, "ranks": ranks}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    ok = all(p["finite"] for r in ranks for p in r["prefill"]) and all(
        t["loss"] == t["loss"] for r in ranks for t in r["train"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
