"""The device trace of a window: ``torch.profiler`` over a few steps, reduced
to what the per-layer metrics read.

* busy: the union of the intervals in which an operation ran on the
  device (kernels, copies, fills), clipped to the window;
* kernels: device seconds and count by name;
* idle gaps: the stretches of the window with nothing on the device,
  each named by the innermost host operation running at its middle
  ("python" where none was), summed by that name.

Each traced run profiles one window in a fresh process: the profiler has
been seen to drop launches of a window that follows earlier profiled
windows in one process.
"""
from __future__ import annotations

import bisect
import time

NAME_CHARS = 100
TOP = 10
# host ranges that are the profiler's or this window's, not the program's
HOST_SKIP = ("bench.window", "Activity Buffer Request")


def _union(intervals: list, lo: float, hi: float) -> list:
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_op(starts: list, cpu: list, t: float) -> str:
    """The innermost host operation running at ``t`` (latest start among
    those that contain it)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4000, -1), -1):
        a, b, name = cpu[j]
        if b >= t:
            return name
    return "python"


def profile_steps(step, n_steps: int, sync) -> dict:
    """Run ``step`` ``n_steps`` times under the profiler, ending in
    ``sync()``; return the reduction (seconds throughout)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step()
            sync()
            wall = time.perf_counter() - t0
    events = prof.events()
    win = [e for e in events if e.name == "bench.window"
           and e.device_type == DeviceType.CPU]
    lo, hi = win[0].time_range.start, win[0].time_range.end
    dev, cpu = [], []
    kernels: dict = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # annotations (this window's own range among them) and gloo's
            # waits are filed as device events; no kernel runs in them
            if (e.name.startswith("gloo:") or e.name == "bench.window"
                    or getattr(e, "is_user_annotation", False)):
                continue
            dev.append((a, b))
            name = e.name[:NAME_CHARS]
            cnt, sec = kernels.get(name, (0, 0.0))
            kernels[name] = (cnt + 1, sec + (b - a) / 1e6)
        elif e.name not in HOST_SKIP and b > a:
            cpu.append((a, b, e.name[:NAME_CHARS]))
    busy = _union(dev, lo, hi)
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: dict = {}
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            name = _host_op(starts, cpu, 0.5 * (a + edge))
            gaps[name] = gaps.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {
        "steps": n_steps,
        "wall_s": wall,
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_s,
        "kernels": kernels,
        "device_ops": [[n, s] for n, (_, s) in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [[n, s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
