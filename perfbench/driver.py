"""One run of one cell: inputs from the seed, the program's set-up, the
checked first steps, the measured window, an optional traced window, and
the comparison with the reference once the window has closed.

A cell on one card runs in this process.  A cell over ranks runs one
process a rank (``torch.multiprocessing``, spawn): every rank builds the
same inputs from the seed and its part of the trainer, and writes a small
report into a directory under ``TMPDIR``; rank 0 also judges the steps;
this process gathers the reports and prints the result.
"""
from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import check
import counts
import devtrace
import graphgen
import partition
import program
import reference

HERE = pathlib.Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")
RANK_TIMEOUT_S = 330.0
CHECK_EVERY = 8


# ---------------------------------------------------------------------------
# the cell's files, found by name
# ---------------------------------------------------------------------------

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: pathlib.Path, name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its workload and
    configuration files, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(root / configs[entry["config"]]["file"])

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return {"name": name, "entry": entry, "workload": workload,
            "config": config, "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def seed_int(seed: int) -> int:
    return int(seed) % (1 << 63)


def make_inputs(config: dict, workload: dict, seed: int):
    """The graph and the community assignment from the seed."""
    g = config["graph"]
    graph = graphgen.sbm_graph(
        g["nodes"], g["avg_degree"], g["classes"], g["features"],
        g["train"], g["test"], g["in_out_ratio"], seed_int(seed))
    part = partition.multilevel_partition(graph.num_nodes, graph.edges,
                                          workload["parts"], seed_int(seed))
    return graph, part


def graph_counts(graph, part) -> dict:
    """N, nnz(Ã) and Σ_m rows of N_m's communities (``counts``)."""
    part = np.asarray(part)
    m = int(part.max()) + 1
    e = graph.edges
    nbr = np.eye(m, dtype=bool)
    nbr[part[e[:, 0]], part[e[:, 1]]] = True
    nbr[part[e[:, 1]], part[e[:, 0]]] = True
    sizes = np.bincount(part, minlength=m)
    return {"n": graph.num_nodes, "nnz": graph.nnz,
            "coupling_rows": int((nbr.astype(np.int64) @ sizes).sum())}


def admm_of(config: dict) -> reference.Admm:
    return reference.Admm(**config["admm"])


# ---------------------------------------------------------------------------
# one process's part of a run
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _w_hash(state) -> str:
    h = hashlib.sha256()
    for w in state.weights:
        h.update(w.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gather_calls(mesh, sink: list, reader_: "program.NodeReader | None"
                  ) -> list:
    """[(node ids, rows)] of one step's aggregations: every rank's outputs
    (each rank's one lane) gathered to rank 0; None on the others."""
    if mesh is None:
        calls = []
        for _, out in sink:
            nodes, rows = reader_.blocked_rows(out)
            calls.append((nodes, rows.cpu()))
        return calls
    import torch.distributed as dist
    calls = []
    for _, out in sink:
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(mesh.world_size)] \
            if mesh.rank == 0 else None
        dist.gather(out, parts, dst=0, group=mesh.group)
        if mesh.rank == 0:
            for r, x in enumerate(parts):
                k = x.shape[0]
                lanes = range(r * k, (r + 1) * k)
                nodes, rows = reader_.blocked_rows(x, lanes)
                calls.append((nodes, rows.cpu()))
    return calls if mesh.rank == 0 else None


def _broadcast(mesh, value: float) -> float:
    if mesh is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return float(t.item())


def _barrier(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.group)


def run_process(spec: dict, seed: int, seconds: float, trace: bool,
                device, t_start: float, mesh=None, hook=None,
                marks: "dict | None" = None) -> dict:
    """This process's part: returns its report (rank 0's carries the
    judged numbers).  ``marks`` are the parts of the start timed before
    this (``start.<part>``: seconds)."""
    wl, cfg = spec["workload"], spec["config"]
    rank = 0 if mesh is None else mesh.rank
    spans = {"start": time.time() - t_start, **(marks or {})}
    if device.type == "cuda":
        # the card's context, before the program's set-up and apart from it
        t = time.perf_counter()
        torch.empty(1, device=device)
        _sync(device)
        spans["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    graph, part = make_inputs(cfg, wl, seed)
    spans["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer = program.build_trainer(cfg, wl, graph, part, seed_int(seed),
                                    device, mesh=mesh)
    dev = trainer.device
    _sync(dev)
    spans["layout"] = time.perf_counter() - t
    if hook is not None:
        hook(trainer)

    # the checked steps: the window's own call, its outputs kept on the host
    t = time.perf_counter()
    nodes = program.NodeReader(trainer) if rank == 0 else None

    def full_state():
        st = trainer.full_state()
        return None if st is None else nodes.state(st)

    # on one card the outputs go to the host as they come, so that the
    # check adds nothing to the card's peak; across ranks they are
    # gathered on the card after the step
    keep = (lambda out: out.detach().cpu()) if mesh is None else None
    states, calls = [full_state()], []
    for _ in range(wl["checked_steps"]):
        sink = []
        with program.capture_aggregations(sink, keep):
            trainer.step()
        calls.append(_gather_calls(mesh, sink, nodes))
        states.append(full_state())
    for _ in range(wl["warm_steps"]):
        trainer.step()
    _sync(dev)
    spans["checked_and_warm_steps"] = time.perf_counter() - t

    # the window: back-to-back steps until ``seconds`` have passed; over
    # ranks rank 0's clock decides, told to every rank every CHECK_EVERY
    # steps (one small broadcast), so that all ranks run the same steps
    _barrier(mesh)
    launches0 = program.launch_counts()
    comm0 = getattr(trainer.comm, "time_s", 0.0)
    _sync(dev)
    t_window = time.time()
    t0 = time.perf_counter()
    steps = 0
    while True:
        trainer.step()
        steps += 1
        if mesh is None or steps % CHECK_EVERY == 0:
            done = float(time.perf_counter() - t0 >= seconds)
            if _broadcast(mesh, done):
                break
    _sync(dev)
    _barrier(mesh)
    window_s = time.perf_counter() - t0
    launches = {k: v - launches0[k]
                for k, v in program.launch_counts().items()}
    comm_s = getattr(trainer.comm, "time_s", 0.0) - comm0

    traced = None
    if trace:
        n_tr = int(_broadcast(mesh, max(
            5, round(wl["trace_seconds"] * steps / window_s))))
        _barrier(mesh)
        traced = devtrace.profile_steps(trainer.step, n_tr,
                                        lambda: _sync(dev))
        _barrier(mesh)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    acc = trainer.epoch_metrics()
    finite = all(bool(torch.isfinite(x).all()) for x in
                 list(trainer.state.weights) + list(trainer.state.zs)
                 + [trainer.state.u])
    report = {
        "rank": rank, "steps": steps, "window_s": window_s,
        "t_window": t_window, "setup_s": t_window - t_start,
        "spans": spans, "launches": launches, "transport_s": comm_s,
        "trace": traced, "memory_peak_bytes": int(peak),
        "accuracy": {"train": acc[0], "test": acc[1],
                     "lagrangian": acc[2], "residual": acc[3]},
        "finite": finite, "w_hash": _w_hash(trainer.state),
        "banned": banned_modules(),
        "graph": graph_counts(graph, part),
    }
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.destroy(mesh)
    if rank == 0:
        t = time.perf_counter()
        prob = reference.build_problem(graph, part, cfg["layer_dims"],
                                       admm_of(cfg), dev)
        report["numbers"] = check.judge(prob, seed_int(seed), states, calls)
        report["spans"]["reference"] = time.perf_counter() - t
        report["banned"] = banned_modules()
    return report


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, store: str, spec: dict, seed: int, seconds: float,
               trace: bool, device, backend: str, t_start: float,
               out_dir: str, hook, marks) -> None:
    from repro_torch.launch import mesh as mesh_lib
    n = spec["workload"]["processes"]
    # the ranks share the host: each its share of the cores
    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    mesh = mesh_lib.init_process_mesh(rank, n,
                                      backend, store, device=device)
    report = run_process(spec, seed, seconds, trace, mesh.device, t_start,
                         mesh=mesh, hook=hook, marks=marks)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def run_ranks(spec: dict, seed: int, seconds: float, trace: bool, device,
              backend: str, t_start: float, hook=None, marks=None) -> list:
    """Every rank's report, in rank order."""
    from repro_torch.launch import mesh as mesh_lib
    n = spec["workload"]["processes"]
    with tempfile.TemporaryDirectory(prefix="perfbench_") as out_dir:
        mesh_lib.run_ranks(_rank_main, n,
                           (spec, seed, seconds, trace, device, backend,
                            t_start, out_dir, hook, marks),
                           timeout=RANK_TIMEOUT_S)
        return [load_json(pathlib.Path(out_dir) / f"rank{r}.json")
                for r in range(n)]


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def peaks_for(kind: str) -> "dict | None":
    table = load_json(HERE / "peaks.json")
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            return table[key]
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(spec: dict, seed: int, seconds: float, trace: bool,
            t_start: float, device=None, backend: "str | None" = None,
            hook=None, log=print, marks: "dict | None" = None) -> dict:
    """Run the cell and return the result line's object: on the card
    unless ``device`` says otherwise (the tests run it on the CPU, with
    ``backend`` gloo across ranks)."""
    wl = spec["workload"]
    backend = backend or wl.get("backend", "nccl")
    if wl.get("processes", 1) > 1:
        reports = run_ranks(spec, seed, seconds, trace, device, backend,
                            t_start, hook, marks)
    else:
        dev = torch.device("cuda" if device is None else device)
        reports = [run_process(spec, seed, seconds, trace, dev, t_start,
                               hook=hook, marks=marks)]
    r0 = reports[0]
    numbers = dict(r0["numbers"])
    if len(reports) > 1:
        numbers["w_rank_diff"] = float(sum(r["w_hash"] != r0["w_hash"]
                                           for r in reports[1:]))
    ok, shown = check.verdict(numbers, wl["limits"])
    acc = r0["accuracy"]
    log(f"accuracy after the window: train {acc['train']:.4f} test "
        f"{acc['test']:.4f}; Lagrangian {acc['lagrangian']:.6g}, residual "
        f"{acc['residual']:.6g}")

    on_card = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    peaks = peaks_for(kind) if on_card else None
    traces = [r["trace"] for r in reports if r.get("trace")]
    run = {
        "chips": len(reports), "steps": r0["steps"],
        "window_s": r0["window_s"], "setup_s": r0["setup_s"],
        "spans": r0["spans"], "launches": r0["launches"],
        "transport_s": r0["transport_s"], "trace": r0.get("trace"),
        "traces": traces, "graph": r0["graph"],
        "dims": spec["config"]["layer_dims"],
        "fista_iters": spec["config"]["admm"]["fista_iters"],
        "peaks": peaks, "on_card": on_card,
    }
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        val = reader(m["name"])(run)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": len(reports),
                   "memory_peak_bytes": max(r["memory_peak_bytes"]
                                            for r in reports)}
    result = {"correct": bool(ok and all(r["finite"] for r in reports)),
              "attempted": r0["steps"],
              "failed": 0 if all(r["finite"] for r in reports)
              else r0["steps"],
              "metrics": metrics, "device": device_info}
    if traces:
        device_info["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device_info["window_s"] = (sum(t["window_s"] for t in traces)
                                   / len(traces))
        result["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                               "idle_gaps": r0["trace"]["idle_gaps"]}
    if peaks is not None:
        log(f"card {kind}, power limit {power_limit()}; peaks FP32 "
            f"{peaks['fp32_flops']:.4g} FLOP/s, HBM "
            f"{peaks['hbm_bytes_per_s']:.4g} B/s")
    log("spans (s): " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in r0["spans"].items()))
    # this process's modules and every rank's, once the window has closed
    result["banned"] = sorted({m for r in reports for m in r["banned"]}
                              | set(banned_modules()))
    result["checks"] = shown
    return result


def verdict_lines(result: dict) -> list:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]
