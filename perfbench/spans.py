"""The trainer's span log laid over the device trace: where a step's
device-idle time goes, by phase.

    python3 perfbench/spans.py --workload <cell> --seed <n> \
        [--seconds 10] [--spans 0|1]

Runs one cell as ``run.py`` does up to its traced window — the inputs from
the seed, the trainer's constructor, the checked and warm steps, a window
of ``--seconds`` — then profiles a window as long as the harness's traced
one (the workload's ``trace_seconds`` at the window's pace).  With
``--spans 1`` the program's span log (``repro_torch.analysis.trace``) is on
for the constructor and the traced window, and off for the other steps.
The window alternates blocks of steps with the log off and on, so that its
cost on the step is read in one process, and its blocks with the log on
give each phase's host ms a step without the profiler's own cost.  Prints
one JSON object, and a table on standard error.  Judges nothing: the
benchmark's metrics are ``run.py``'s.

The join (``join``): each span is put on the profiler's clock through the
log's anchor (``time.perf_counter_ns`` read beside ``time.time_ns``, the
clock torch.profiler measures its events from).  The window's idle time
(no device interval running, ``devtrace``'s busy union) is split at span
boundaries and each piece filed under the innermost span over it, or
outside every span.  Per span name: count, host seconds, self seconds
(the span less its children) and device-idle seconds, each a step.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = pathlib.Path.cwd()
BLOCK = 10          # steps a block of the window, the log off or on
LAUNCH = ("cudaLaunch", "cuLaunch")
STEP = "admm.step"  # the program's root span of one trainer step


# ---------------------------------------------------------------------------
# the join, on intervals in one unit
# ---------------------------------------------------------------------------

def complement(busy: list, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that the sorted disjoint ``busy``
    intervals leave uncovered."""
    out, edge = [], lo
    for a, b in busy:
        if a > edge:
            out.append((edge, min(a, hi)))
        edge = max(edge, b)
        if edge >= hi:
            break
    if edge < hi:
        out.append((edge, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: list, lo: float, hi: float) -> list:
    """[(a, b, i)] covering [lo, hi] in order: ``i`` the innermost of the
    nested ``spans`` [(start, end, i)] over [a, b), -1 where none is."""
    out = []

    def emit(a, b, i):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, i))

    stack: list = []                       # (end, i), outermost first
    t = lo
    for s, e, i in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, j = stack.pop()
            emit(t, end, j)
            t = max(t, end)
        emit(t, s, stack[-1][1] if stack else -1)
        t = max(t, s)
        stack.append((e, i))
    while stack:
        end, j = stack.pop()
        emit(t, end, j)
        t = max(t, end)
    emit(t, hi, -1)
    return out


def file_idle(segments: list, idle: list) -> dict:
    """Span index (-1: none) -> the idle time over its ``segments``
    (``innermost``'s, sorted) from the sorted ``idle`` intervals."""
    out: dict = {}
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            sa, sb, i = segments[k]
            ov = min(b, sb) - max(a, sa)
            if ov > 0:
                out[i] = out.get(i, 0.0) + ov
            k += 1
    return out


def join(log, busy: list, lo: float, hi: float, to_us, launches=()
         ) -> dict:
    """The span log ``log`` over a profiled window [lo, hi] (µs on the
    profiler's clock, ``busy`` its device union): ``to_us`` maps a span's
    ``perf_counter_ns`` onto that clock; ``launches`` are the window's
    kernel-launch host times.  Only the steps that lie in the window
    count.  Seconds throughout; ``by_span`` per name, in the order the
    names first appear."""
    keep = {log.steps[i] for i in range(len(log))
            if log.names[i] == STEP and log.end_ns[i] >= 0
            and lo <= to_us(log.start_ns[i]) and to_us(log.end_ns[i]) <= hi}
    steps = sorted(keep)
    idx = [i for i in range(len(log)) if log.steps[i] in keep
           and log.end_ns[i] >= 0]
    spans = [(to_us(log.start_ns[i]), to_us(log.end_ns[i]), i) for i in idx]
    idle = complement(busy, lo, hi)
    filed = file_idle(innermost(spans, lo, hi), idle)
    inner = {i: 0.0 for i in idx}            # idle in a span's subtree
    for i, v in filed.items():
        while i >= 0:
            if i in inner:
                inner[i] += v
            i = log.parents[i]
    table = log.summary(steps)
    for name in table:
        table[name]["idle_s"] = 0.0
        table[name]["idle_in_s"] = 0.0
    for i in idx:
        row = table[log.names[i]]
        row["idle_s"] += filed.get(i, 0.0) * 1e-6
        row["idle_in_s"] += inner[i] * 1e-6
    roots = sorted((to_us(log.start_ns[i]), to_us(log.end_ns[i]))
                   for i in idx if log.names[i] == STEP)
    starts = [a for a, _ in roots]
    inside = 0
    for t in launches:
        k = bisect.bisect_right(starts, t) - 1
        inside += k >= 0 and t <= roots[k][1]
    idle_s = sum(b - a for a, b in idle) * 1e-6
    return {
        "steps": len(steps),
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "idle_s": idle_s,
        "idle_filed_s": sum(v for i, v in filed.items() if i >= 0) * 1e-6,
        "idle_outside_s": filed.get(-1, 0.0) * 1e-6,
        "launches": len(launches),
        "launches_in_steps": int(inside),
        "by_span": table,
    }


def per_step(joined: dict) -> dict:
    """``join``'s table as ms a step (host, self, device-idle, the idle in
    the span's subtree) and the count a step."""
    n = max(joined["steps"], 1)
    return {name: {"count": r["count"] / n,
                   "host_ms": 1e3 * r["host_s"] / n,
                   "self_ms": 1e3 * r["self_s"] / n,
                   "idle_ms": 1e3 * r["idle_s"] / n,
                   "idle_in_ms": 1e3 * r["idle_in_s"] / n}
            for name, r in joined["by_span"].items()}


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

def profile_window(step, n_steps: int, sync) -> tuple:
    """``n_steps`` of ``step`` under torch.profiler: (events, the window's
    [lo, hi] µs, the profiler's clock start in ``time_ns``, the host wall
    seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("spans.window"):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step()
            sync()
            wall = time.perf_counter() - t0
    events = prof.events()
    win = [e for e in events if e.name == "spans.window"][0]
    return (events, (win.time_range.start, win.time_range.end),
            prof.profiler.kineto_results.trace_start_ns(), wall)


def device_and_launches(events, lo: float, hi: float) -> tuple:
    """The device union in [lo, hi] (``devtrace``'s) and the kernel-launch
    host times in it."""
    import devtrace
    from torch.autograd import DeviceType
    dev, launches = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if (e.name.startswith("gloo:") or e.name == "spans.window"
                    or getattr(e, "is_user_annotation", False)):
                continue
            dev.append((a, b))
        elif e.name.startswith(LAUNCH) and lo <= a <= hi:
            launches.append(a)
    return devtrace._union(dev, lo, hi), sorted(launches)


def run_cell(spec: dict, seed: int, seconds: float, spans_on: bool,
             device) -> dict:
    """One run: the result object (see the module's docstring)."""
    import torch

    import driver
    import program
    from repro_torch.analysis import trace
    wl, cfg = spec["workload"], spec["config"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    graph, part = driver.make_inputs(cfg, wl, seed)
    log = trace.SpanLog()

    def logged():
        return trace.spans(log) if spans_on else contextlib.nullcontext()

    t = time.perf_counter()
    with logged():
        trainer = program.build_trainer(cfg, wl, graph, part,
                                        driver.seed_int(seed), device)
    sync()
    layout_s = time.perf_counter() - t
    for _ in range(wl["checked_steps"] + wl["warm_steps"]):
        trainer.step()
    sync()

    # the window: blocks of steps, the log off and on in turn
    times = {False: [0.0, 0], True: [0.0, 0]}
    window_log = trace.SpanLog()
    on = False
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end or not times[True][1]:
        sync()
        t0 = time.perf_counter()
        with trace.spans(window_log) if on else contextlib.nullcontext():
            for _ in range(BLOCK):
                trainer.step()
            sync()
        times[on][0] += time.perf_counter() - t0
        times[on][1] += BLOCK
        on = not on
    steps = times[False][1] + times[True][1]
    pace = (times[False][0] + times[True][0]) / max(steps, 1)
    n_tr = max(5, round(wl["trace_seconds"] / pace))

    mark, counts0 = len(log), dict(log.counts)
    with logged():
        events, (lo, hi), start_ns, wall = profile_window(trainer.step, n_tr,
                                                          sync)
    busy, launches = device_and_launches(events, lo, hi)

    def to_us(t_ns):
        return (log.wall_ns(t_ns) - start_ns) * 1e-3

    out = {
        "workload": spec["name"], "seed": seed, "spans": spans_on,
        "layout_s": layout_s,
        "window": {"steps_off": times[False][1], "steps_on": times[True][1],
                   "ms_a_step_off": 1e3 * times[False][0]
                   / max(times[False][1], 1),
                   "ms_a_step_on": 1e3 * times[True][0]
                   / max(times[True][1], 1)},
        "traced": {"steps": n_tr, "wall_ms_a_step": 1e3 * wall / n_tr,
                   "window_s": (hi - lo) * 1e-6,
                   "busy_s": sum(b - a for a, b in busy) * 1e-6,
                   "launches": len(launches)},
    }
    # the window's blocks with the log on, unprofiled: host ms a step
    n_on = max(window_log.n_steps, 1)
    out["window_by_span_ms"] = {
        name: {"count": r["count"] / n_on, "host_ms": 1e3 * r["host_s"] / n_on,
               "self_ms": 1e3 * r["self_s"] / n_on}
        for name, r in window_log.summary().items()}
    if not spans_on:
        return out
    layout = {n: 1e-9 * (e - s) for n, s, e, st in
              zip(log.names[:mark], log.start_ns[:mark], log.end_ns[:mark],
                  log.steps[:mark]) if n.startswith("layout") and st < 0}
    j = join(log, busy, lo, hi, to_us, launches)
    table = per_step(j)
    reads = {k.split(".", 1)[1]: v - counts0.get(k, 0)
             for k, v in log.counts.items() if k.startswith("host_reads.")}
    out.update({
        "layout_spans_s": layout,
        "joined": {k: v for k, v in j.items() if k != "by_span"},
        "by_span_ms": table,
        "host_reads_a_step": sum(reads.values()) / n_tr,
        "host_reads_by_site": reads,
        "search_idle_ms": table.get("admm.probe", {}).get("idle_in_ms", 0.0),
    })
    return out


def show(out: dict) -> list:
    """The result as lines of a table."""
    lines = [f"{out['workload']} seed {out['seed']}: window ms a step, log "
             f"off {out['window']['ms_a_step_off']:.3f} / on "
             f"{out['window']['ms_a_step_on']:.3f}; traced "
             f"{out['traced']['wall_ms_a_step']:.3f} ms a step over "
             f"{out['traced']['steps']} steps"]
    if "by_span_ms" not in out:
        return lines
    j = out["joined"]
    lines.append(f"idle {j['idle_s']:.4f} s of {j['window_s']:.4f}: filed "
                 f"{j['idle_filed_s']:.4f}, outside {j['idle_outside_s']:.4f}"
                 f"; launches in steps {j['launches_in_steps']} of "
                 f"{j['launches']}; host reads a step "
                 f"{out['host_reads_a_step']:.2f} "
                 f"{out['host_reads_by_site']}; search idle ms a step "
                 f"{out['search_idle_ms']:.3f}")
    lines.append(f"{'span':24s} {'count':>7s} {'host ms':>9s} "
                 f"{'self ms':>9s} {'idle ms':>9s} {'idle in':>9s}  "
                 f"{'unprofiled host / self ms':>25s}")
    plain = out["window_by_span_ms"]
    for name, r in out["by_span_ms"].items():
        w = plain.get(name, {"host_ms": 0.0, "self_ms": 0.0})
        lines.append(f"{name:24s} {r['count']:7.2f} {r['host_ms']:9.3f} "
                     f"{r['self_ms']:9.3f} {r['idle_ms']:9.3f} "
                     f"{r['idle_in_ms']:9.3f}  {w['host_ms']:12.3f} "
                     f"{w['self_ms']:12.3f}")
    lines.append("layout (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["layout_spans_s"].items()))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(HERE))
    import torch

    import driver
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 3
    spec = driver.cell_spec(ROOT, args.workload)
    dev = torch.device("cuda")
    torch.empty(1, device=dev)
    out = run_cell(spec, args.seed, args.seconds, bool(args.spans), dev)
    out["card"] = driver.power_limit()
    for line in show(out):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
