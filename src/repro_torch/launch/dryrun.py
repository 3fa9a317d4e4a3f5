"""Multi-pod dry run on the ``meta`` device (src/repro/launch/dryrun.py):
one rank's step of every arch × input shape on the production meshes —
16 × 16 (one pod, 256 ranks) and 2 × 16 × 16 (512 ranks) — with nothing
allocated.

The reference lowers and compiles each step from ``ShapeDtypeStruct``
stand-ins and reads XLA's memory and cost analyses of one device's
program.  The port runs eagerly, so it runs the step itself, as rank
``--rank`` of a mesh whose other ranks do not exist
(``launch.mesh.stand_in_mesh``: torch's fake process group under the real
axes and sub-groups), on ``meta`` tensors of this rank's shapes:

  * parameters: ``param_specs`` cut to this rank's ``local_shape``;
    Adam state ``init_optimizer().init`` of them; the batch from
    ``input_specs`` (a training step takes this rank's rows,
    ``launch.mesh.batch_rows``; the forward paths take the global batch);
    decode caches ``init_cache(..., mesh=...)``;
  * steps, the reference's routes: ``train`` is ``train_step_deferred``
    over the ranks (``train_step`` on a mesh of one rank, the step a
    process that trains alone runs), ``prefill`` is ``forward(...,
    last_only=True)``, ``decode`` is ``decode_step``; over ranks inside
    ``sharding_hints(mesh, moe_a2a=--opt)``.

Per combination it records what one rank holds and does:
``analysis.memory.MemoryTracker`` (bytes by storage: the arguments, the
outputs, the peak and the peak by dtype),
``torch.utils.flop_counter.FlopCounterMode``, the op trace's census
(``analysis.trace``), the bytes ``MeshCollectives`` counts along each
axis, and the reference's ``analytic_hbm_bytes`` and
``model_flops`` (``launch.roofline``), in
``results/dryrun_torch/<arch>__<shape>__<mesh>[__opt].json`` with the
reference's keys (``benchmarks/dryrun_summary.py`` reads them).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all [--multi-pod] [--opt] [--rank R]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary   # table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import trace
from repro_torch.analysis.memory import MemoryTracker, storage_bytes
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.shapes import InputShape
from repro_torch.core.messages import COUNTERS, MeshCollectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.models import layers
from repro_torch.models.build import _param_shapes, make_model
from repro_torch.sharding import hints, partition

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# long_500k: dense/MoE/VLM/audio archs run their sliding-window variant
LONG_CONTEXT_WINDOW = 4096
SUBQUADRATIC = ("ssm", "hybrid")
H100_BYTES = 80e9          # an H100 80GB's memory, as its name gives it

NOTES = [
    "meta-device run of this rank's eager step (no allocation); memory by "
    "storage (analysis.memory), flops by FlopCounterMode",
    "lower_s: seconds to build the rank's stand-ins; compile_s: seconds to "
    "run the step on them (nothing is compiled)",
]
PLAIN_NOTE = ("plain form: sharding hints without the all-to-all MoE "
              "(XLA's own partitioning of an unannotated step has no eager "
              "counterpart)")
OPT_NOTE = "optimized: sharding hints + the all-to-all MoE (moe_a2a)"


def adapt_config(arch: str, shape: InputShape):
    cfg = get_config(arch)
    notes = []
    if shape.name == "long_500k" and cfg.arch_type not in SUBQUADRATIC:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
        notes.append(f"sliding_window={LONG_CONTEXT_WINDOW} (long_500k "
                     "sub-quadratic variant)")
    return cfg, notes


@dataclasses.dataclass
class Step:
    """One rank's step: ``fn(comm)`` runs it on ``args`` (the trees it
    reads by name: ``params``, ``opt_state``, ``batch``, ``caches``)."""
    fn: Callable
    args: dict
    notes: list


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def build_step(cfg, shape: InputShape, mesh, optimized: bool = False,
               device: "str | torch.device" = "meta") -> Step:
    """This rank's stand-ins on ``device`` (zeros; ``meta`` allocates
    nothing) and its step, for ``mesh`` a ``ProcessMesh`` of any shape.
    A training batch whose rows do not divide over the data ranks or into
    ``grad_accum`` microbatches is refused."""
    model = make_model(cfg)
    ranks = mesh.size > 1
    rolling = shape.name == "long_500k" and cfg.arch_type not in SUBQUADRATIC
    notes = [OPT_NOTE if optimized else PLAIN_NOTE] if ranks else []
    params = partition.local_filled(_param_shapes(cfg),
                                    model.param_specs(mesh), mesh, device, {})
    batch = {k: _zeros(v.shape, v.dtype, device)
             for k, v in model.input_specs(shape).items()}
    if shape.step == "train":
        opt_state = model.init_optimizer().init(params)
        rows = mesh_lib.batch_rows(mesh, shape.global_batch)
        n = rows.stop - rows.start
        accum = max(cfg.grad_accum, 1)
        if n % accum:
            raise ValueError(f"{n} rows a data rank do not split into "
                             f"grad_accum={accum} microbatches")
        batch = {k: _zeros((n,) + tuple(v.shape[1:]), v.dtype, device)
                 for k, v in batch.items()}
        if ranks:
            notes.append(f"train_step_deferred over ranks: {n} of "
                         f"{shape.global_batch} rows a data rank")

            def fn(comm):
                return model.train_step_deferred(mesh, params, opt_state,
                                                 batch, comm=comm)
        else:
            def fn(comm):
                return model.train_step(params, opt_state, batch)
        return Step(fn, {"params": params, "opt_state": opt_state,
                         "batch": batch}, notes)
    if shape.step == "prefill":
        def fn(comm):
            return model.forward(params, batch, last_only=True)[0]
        return Step(fn, {"params": params, "batch": batch}, notes)
    caches = model.init_cache(shape.global_batch, shape.seq_len,
                              rolling=rolling, device=device,
                              mesh=mesh if ranks else None)
    tokens = batch["tokens"]

    def fn(comm):
        return model.decode_step(params, caches, tokens, rolling=rolling)
    return Step(fn, {"params": params, "caches": caches,
                     "batch": {"tokens": tokens}}, notes)


def _run(step: Step, mesh, optimized: bool):
    """The step's outputs and the bytes its collectives counted, by
    counter (``MeshCollectives``' ``<name>_bytes``, their total and the
    calls behind each): over ranks inside ``sharding_hints(mesh,
    moe_a2a=optimized)``."""
    if mesh.size == 1:
        return step.fn(None), dict(
            {f"{c}_bytes": 0 for c in COUNTERS}, total_bytes=0,
            calls={f"{c}_bytes": 0 for c in COUNTERS})
    comm = MeshCollectives(mesh)
    with hints.sharding_hints(mesh, moe_a2a=optimized, comm=comm):
        out = step.fn(comm)
    moved = {f"{c}_bytes": getattr(comm, f"{c}_bytes") for c in COUNTERS}
    return out, dict(moved, total_bytes=sum(moved.values()),
                     calls={f"{c}_bytes": comm.calls[c] for c in COUNTERS})


def count_collectives(cfg, shape: InputShape, mesh,
                      optimized: bool = False) -> dict:
    """``measure``'s ``collectives`` alone: this rank's step on ``meta``
    with no counting mode over it (the cheap way to the bytes along each
    axis)."""
    return _run(build_step(cfg, shape, mesh, optimized), mesh, optimized)[1]


def measure(cfg, shape: InputShape, mesh, optimized: bool = False,
            device: "str | torch.device" = "meta") -> dict:
    """Run this rank's step (``build_step``) once and count what it holds
    and does: memory by storage, FLOPs, the op trace's census and the
    collectives' bytes by counter.  The step runs the same code on real
    tensors (``device="cpu"``), for the counts to be held against."""
    t0 = time.perf_counter()
    step = build_step(cfg, shape, mesh, optimized, device)
    lower_s = time.perf_counter() - t0
    tracker = MemoryTracker(watch=layers.f32_copy_bytes)
    argument = tracker.hold(step.args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with trace.record() as tape, flops, tracker:
        out, collectives = _run(step, mesh, optimized)
    compile_s = time.perf_counter() - t0
    output = storage_bytes(out)
    del out
    census = trace.trace_census(tape)
    del tape
    chips = mesh.size
    return {
        "mesh": "x".join(map(str, mesh.dims or (mesh.size,))),
        "chips": chips,
        "rank": mesh.rank,
        "step": shape.step,
        "notes": NOTES + step.notes,
        "lower_s": lower_s,
        "compile_s": compile_s,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {"argument_bytes": argument,
                   "arguments": {k: storage_bytes(v)
                                 for k, v in step.args.items()},
                   "output_bytes": output,
                   "temp_bytes": tracker.peak - argument,
                   "peak_bytes": tracker.peak,
                   "peak_by_dtype": tracker.peak_by_dtype,
                   "f32_unembed_bytes_at_peak": tracker.at_peak},
        "cost": {"flops": flops.get_total_flops()},
        "census": {"flops": census.flops, "hbm_bytes": census.hbm_bytes,
                   "collective_bytes": collectives["total_bytes"],
                   "ops": census.ops},
        "analytic_hbm_bytes": roofline.analytic_hbm_bytes(
            cfg, shape, shape.step, chips),
        "model_flops": roofline.model_flops(cfg, shape, shape.step),
        "collectives": collectives,
        "fits_h100_80gb": tracker.peak <= H100_BYTES,
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Path = RESULTS_DIR, optimized: bool = False,
            rank: int = 0) -> dict:
    _, dims = mesh_lib.PRODUCTION_SHAPES[multi_pod]
    shape = INPUT_SHAPES[shape_name]
    cfg, notes = adapt_config(arch, shape)
    with mesh_lib.stand_in_mesh(dims, rank) as mesh:
        measured = measure(cfg, shape, mesh, optimized)
    result = dict({"arch": arch, "shape": shape_name}, **measured)
    result["notes"] = notes + measured["notes"]
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "__opt" if optimized else ""
    out = out_dir / f"{arch}__{shape_name}__{result['mesh']}{suffix}.json"
    out.write_text(json.dumps(result, indent=2))
    return result


def summary(out_dir: Path = RESULTS_DIR) -> list[str]:
    """The JSONs under ``out_dir`` as markdown, a table per mesh and form
    with a row per arch and a column per input shape.  A cell: peak GB a
    rank, whether that fits an H100 80GB, FLOPs a rank ÷ (``model_flops``
    / ranks), and GB leaving a rank along ``model`` (``model_bytes`` +
    ``a2a_bytes``) / along the data axes and other lines (``sum_bytes`` +
    ``line_bytes``)."""
    tables: dict = {}
    for path in sorted(out_dir.glob("*.json")):
        r = json.loads(path.read_text())
        form = r["mesh"] + (" opt" if path.stem.endswith("__opt") else "")
        c = r["collectives"]
        ratio = r["cost"]["flops"] / (r["model_flops"] / r["chips"])
        tables.setdefault(form, {})[(r["arch"], r["shape"])] = (
            f"{r['memory']['peak_bytes'] / 1e9:.1f} "
            f"{'yes' if r['fits_h100_80gb'] else 'no'} · {ratio:.3g} · "
            f"{(c['model_bytes'] + c['a2a_bytes']) / 1e9:.3g} / "
            f"{(c['sum_bytes'] + c['line_bytes']) / 1e9:.3g}")
    rows = []
    for form, cells in tables.items():
        rows += ["", f"| {form} | " + " | ".join(INPUT_SHAPES) + " |",
                 "| --- |" + " --- |" * len(INPUT_SHAPES)]
        rows += [f"| {arch} | " + " | ".join(
            cells.get((arch, shape), "—") for shape in INPUT_SHAPES) + " |"
            for arch in list_archs()]
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="optimized variant (sharding hints + the "
                         "all-to-all MoE) -> *__opt.json")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step runs (default 0)")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--summary", action="store_true",
                    help="print the JSONs under --out as a table and exit")
    args = ap.parse_args(argv)
    if args.summary:
        print("\n".join(summary(Path(args.out))))
        return {}

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    mesh_name = "2x16x16" if args.multi_pod else "16x16"

    results, failures = {}, []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} × {shape} × {mesh_name}" + \
                (" [opt]" if args.opt else "")
            try:
                r = run_one(arch, shape, args.multi_pod, Path(args.out),
                            optimized=args.opt, rank=args.rank)
                peak = r["memory"]["peak_bytes"]
                print(f"[dryrun] OK   {tag}: run {r['compile_s']:.1f}s, "
                      f"peak {peak / 2**30:.2f} GiB/chip, flops "
                      f"{r['cost']['flops']:.4g}", flush=True)
                results[tag] = r
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + "; ".join(t for t, _ in failures))
    print("[dryrun] all combinations ran")
    return results


if __name__ == "__main__":
    main()
