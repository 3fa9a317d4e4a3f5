#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the community-ADMM GCN trainer on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernel from the repository's sources;
  2. hold the kernel against its plain PyTorch version on the card at the
     trainer's shapes, on a ragged layout, with bf16 blocks and with
     masked slots whose indices point anywhere (max |diff| <= 1e-5 max |ref|);
  3. train the paper's GCN (767, 1000, 10) on the 13,752-node synthetic
     amazon_computers graph, M = 3 communities, packed state, through the
     kernel, for 3 epochs; every value must be finite and the kernel must
     have launched; compare objectives and one step of the kernel path and
     the plain path from one shared state;
  4. time the kernel, its plain version and the gather + einsum
     composition at the trainer's shapes, beside the card's bound;
  5. print the kernels line, the card's name and power limit, and a last
     line {"ok": true, "device": {...}}.

Imports torch and the port (src/repro_torch) only.  Needs one CUDA device
and exits non-zero without one, or without the port beside it.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
TOL = 1e-5                     # max |kernel − plain| ≤ TOL · max |plain|
EPOCHS = 3
KERNEL_SRC = "src/repro_torch/kernels/csrc/community_spmm_ell.cu"
REPLACES = "src/repro/kernels/community_spmm.py:359"

# Published peaks per H100 variant (NVIDIA data sheets): FP32 outside the
# tensor cores (FLOP/s) and HBM bandwidth (bytes/s).
PEAKS = {"H100 NVL": (60e12, 3.9e12), "H100 PCIe": (51e12, 2.0e12),
         "H100": (67e12, 3.35e12)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peaks for card {name!r}")


def rel_err(out, ref) -> tuple[float, float]:
    """(max |out − ref|, that over max |ref|)."""
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err / scale if scale else err


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_us(events) -> float:
    """Microseconds the card was busy: the union of the intervals of the
    device events (kernels, copies, fills) the profiler traced.  Host ops
    are left out: their device time is that of the kernels they launched,
    which appear as events of their own."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def work(blocks, idx, mask, rows, nbrs, c: int) -> tuple[float, float]:
    """(FLOPs, bytes) the ELL aggregation needs for these operands: only
    live slots, only rows inside the counts; each input read once (a Z row
    read by several slots counts once), the output written once."""
    import torch
    k, d, n = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    live = (mask != 0)
    r = torch.clamp(rows, max=n).double()[:, None]
    p = torch.clamp(nbrs, max=n).double() * live
    pairs = float((r * p).sum())
    z_rows = {}
    for slot in range(k * d):
        m_, d_ = divmod(slot, d)
        if live[m_, d_]:
            key = int(idx[m_, d_])
            z_rows[key] = max(z_rows.get(key, 0.0), float(p[m_, d_]))
    nbytes = (pairs * blocks.element_size() + sum(z_rows.values()) * c * 4
              + k * n * c * 4 + 4 * (3 * k * d + k))
    return 2.0 * c * pairs, nbytes


def check_case(name, blocks, idx, mask, z, rows, nbrs, log) -> float:
    import torch

    from repro_torch.kernels import community_spmm, ref
    out = community_spmm.community_spmm_ell(blocks, idx, mask, z, rows, nbrs)
    torch.cuda.synchronize()
    want = ref.community_spmm_ell_einsum(blocks, idx, mask, z, rows, nbrs)
    err, rel = rel_err(out, want)
    ok = bool(torch.isfinite(out).all()) and rel <= TOL
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel})
    print(f"[2] {name}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"kernel disagrees with its plain version on {name}")
    return err


def objective_gap(trainer) -> float:
    """Largest relative difference between the kernel path and the plain
    path over every W- and Z-update objective value and gradient at the
    trainer's current state."""
    obj_k = trainer.objectives(use_kernel=True)
    obj_p = trainer.objectives(use_kernel=False)
    worst = 0.0
    for kind in ("w", "z"):
        for (vk, gk), (vp, gp) in zip(obj_k[kind], obj_p[kind]):
            for a, b in ((vk, vp), (gk, gp)):
                worst = max(worst, rel_err(a, b)[1])
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import gcn_paper
    from repro_torch.core import graph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.kernels import build, community_spmm, ref
    from repro_torch.util.device import strict_f32

    strict_f32()
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[0] {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {card}", flush=True)

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.load(community_spmm.LIB)
    print(f"[1] built {KERNEL_SRC} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---- 2. kernel vs plain version on the card ----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    checks: list[dict] = []
    max_abs = 0.0
    k = d = 3
    n_full = 4584
    blocks_full = torch.randn((k, d, n_full, n_full), generator=gen,
                              device=dev)
    idx_full = torch.arange(d, **i32).repeat(k, 1).contiguous()
    ones = torch.ones((k, d), **i32)
    rows_full = torch.full((k,), n_full, **i32)
    nbrs_full = torch.full((k, d), n_full, **i32)
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        max_abs = max(max_abs, check_case(
            f"full k=D=3 n_pad={n_full} C={c} f32", blocks_full, idx_full,
            ones, z, rows_full, nbrs_full, checks))
    z = torch.randn((k, n_full, 1000), generator=gen, device=dev)
    max_abs = max(max_abs, check_case(
        f"full k=D=3 n_pad={n_full} C=1000 bf16",
        blocks_full.to(torch.bfloat16), idx_full, ones, z, rows_full,
        nbrs_full, checks))
    del z

    g_r, part_r = graph.synthetic_powerlaw_communities(
        32, nodes_per_part=32, size_skew=1.0)
    lay = graph.build_community_layout(g_r.num_nodes, g_r.edges, part_r,
                                       compressed=True, pad_mode="bucketed")
    csr = lay.compress()
    rc, nc = csr.ell_row_counts()
    if not (rc < lay.n_pad).any():
        fail("the ragged layout has no row count below n_pad")
    rng = np.random.default_rng(0)
    m_r = csr.num_parts
    # masked slots point anywhere in range: their indices are never read
    idx_r = np.where(csr.ell_mask > 0, csr.ell_indices,
                     rng.integers(0, m_r, size=csr.ell_indices.shape))
    ragged = [torch.as_tensor(x, device=dev) for x in
              (csr.ell_blocks, idx_r.astype(np.int32),
               (csr.ell_mask != 0).astype(np.int32), rc, nc)]
    for c, dt in ((64, torch.float32), (10, torch.float32),
                  (64, torch.bfloat16)):
        z = torch.randn((m_r, lay.n_pad, c), generator=gen, device=dev)
        b, ix, mk, r_, n_ = ragged
        max_abs = max(max_abs, check_case(
            f"ragged M=32 n_pad={lay.n_pad} D={csr.max_deg} C={c} "
            f"{str(dt).split('.')[-1]} (masked slots re-pointed)",
            b.to(dt), ix, mk, z, r_, n_, checks))
    max_rel = max(ch["max_rel_err"] for ch in checks)

    # ---- 3. the trainer at full width -------------------------------------
    cfg, admm = gcn_paper.config("amazon_computers")
    t0 = time.perf_counter()
    g = graph.synthetic_sbm("amazon_computers", seed=0)
    trainer = ParallelADMMTrainer(cfg, admm, g, num_parts=3, seed=0,
                                  config=TrainerConfig.packed(use_kernel=True),
                                  device="cuda")
    torch.cuda.synchronize()
    lay = trainer.layout
    print(f"[3] set-up {time.perf_counter() - t0:.1f} s: {g.num_nodes} nodes, "
          f"{g.num_edges} edges, GCN {cfg.layer_dims}, M={lay.num_parts}, "
          f"n_pad={lay.n_pad}, row counts {lay.eff_row_counts().tolist()}, "
          f"max_deg {trainer.layout.compress().max_deg}, packed plane "
          f"{trainer.packed_layout.total_rows} rows", flush=True)

    # objectives and one step, kernel path vs plain path, one shared state
    s0 = trainer.state
    worst0 = objective_gap(trainer)
    print(f"[3] initial state: objectives and gradients, kernel vs plain "
          f"path: max rel diff {worst0:.3e} (reported: every residual of "
          f"the initial state is float noise)", flush=True)
    s_k = trainer.next_state(s0, use_kernel=True)
    s_p = trainer.next_state(s0, use_kernel=False)
    same = all(torch.equal(a, b) for a, b in
               zip(s_k.taus + s_k.thetas, s_p.taus + s_p.thetas))
    print(f"[3] one step from the initial state: tau/theta agree between "
          f"kernel and plain paths: {same} (reported, not asserted: a "
          f"reassociation may flip a line search)", flush=True)
    trainer.state = s0
    del s_k, s_p

    community_spmm.launches = 0
    log = trainer.train(EPOCHS)
    launches = community_spmm.launches
    for i in log.epoch:
        print(f"[3] epoch {i}: step {1e3 * log.epoch_time_s[i]:.1f} ms, "
              f"lagrangian {log.lagrangian[i]:.6f}, residual "
              f"{log.residual[i]:.6e}, train {log.train_acc[i]:.4f}, test "
              f"{log.test_acc[i]:.4f}", flush=True)
    values = (log.lagrangian + log.residual + log.train_acc + log.test_acc
              + log.epoch_time_s)
    if not all(math.isfinite(v) for v in values):
        fail("a non-finite value in the training log")
    st = trainer.state
    for t in st.weights + st.zs + (st.u,) + st.taus + st.thetas:
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite value in the trainer state")
    if launches == 0:
        fail("the training run never launched the CUDA kernel")
    worst = objective_gap(trainer)
    print(f"[3] trained state: objectives and gradients, kernel vs plain "
          f"path: max rel diff {worst:.3e}", flush=True)
    if not worst <= TOL:
        fail(f"objectives differ between paths by {worst:.3e}")
    community_spmm.launches = 0
    trainer.step()
    per_step = community_spmm.launches
    print(f"[3] kernel launches: {launches} in {EPOCHS} epochs "
          f"({launches / EPOCHS:g} per epoch), {per_step} per step",
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us = device_busy_us(prof.events())
    idle = (f"{1.0 - busy_us / wall_us:.4f}" if busy_us > 0 else
            "not measured (the profiler traced no device activity)")
    print(f"[3] profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, device idle share {idle}", flush=True)

    # ---- 4. times -----------------------------------------------------------
    peak_flops, peak_bw = peaks(name)
    per_c = {}
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        args = (blocks_full, idx_full, ones, z, rows_full, nbrs_full)

        def composition(z=z):
            zg = z[idx_full.long()] * ones[..., None, None].float()
            return torch.einsum("mdip,mdpc->mic", blocks_full, zg)

        before = community_spmm.launches
        ms = median_ms(lambda: community_spmm.community_spmm_ell(*args), 7)
        community_spmm.launches = before      # timing launches do not count
        plain_ms = median_ms(lambda: ref.community_spmm_ell_einsum(*args), 5)
        lib_ms = median_ms(composition, 5)
        flops, nbytes = work(blocks_full, idx_full, ones, rows_full,
                             nbrs_full, c)
        t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
        per_c[c] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        print(f"[4] C={c}: kernel {ms:.3f} ms, plain version {plain_ms:.3f} "
              f"ms, gather+einsum {lib_ms:.3f} ms, bound "
              f"{per_c[c]['bound_ms']:.3f} ms ({per_c[c]['bound_by']}; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) "
              f"[{card}]", flush=True)
        del z
    steps = log.epoch_time_s
    print(f"[4] full-width step: median {1e3 * statistics.median(steps):.1f} "
          f"ms over {len(steps)} epochs (first includes warm-up), launches "
          f"{per_step}/step, {launches / EPOCHS:g}/epoch, idle share {idle} "
          f"[{card}]", flush=True)

    # ---- 5. the kernels line, the card, the result --------------------------
    main_c = 1000
    row = {"name": "community_spmm_ell", "route": "cuda",
           "source": KERNEL_SRC, "replaces": REPLACES,
           "launches": launches, "max_abs_err": max_abs,
           "ms": per_c[main_c]["ms"], "plain_ms": per_c[main_c]["plain_ms"],
           "bound_ms": per_c[main_c]["bound_ms"],
           "bound_by": per_c[main_c]["bound_by"],
           "library_ms": per_c[main_c]["library_ms"],
           "timed_at": {"k": k, "max_deg": d, "n_pad": n_full, "C": main_c},
           "checked": True, "max_rel_err": max_rel,
           "per_c": {str(c): v for c, v in per_c.items()}}
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
