"""What the kernel ablations share: a hand-written kernel's source with
textual changes, each variant built beside the others with nvcc, and timed
by CUDA events or by the profiler's device time per kernel.

The card's kernel profilers (ncu, nsys) are not always available, so
``ell_ablation``, ``flash_ablation`` and ``ssd_ablation`` measure what a
part of a kernel costs by taking it away or by changing its tiling.
"""
from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build


def variant_source(source, changes, tool: str) -> str:
    """The text of ``source`` (a path) with ``changes`` made: ``(old, new)``
    replaces every ``old``; a pair of texts as ``old`` replaces the span from
    the first up to the second.  Raises if the kernel no longer holds a text
    a change names."""
    src = source.read_text()
    for old, new in changes:
        if isinstance(old, tuple):
            start, end = old
            i = src.find(start)
            j = src.find(end)
            if i < 0 or j < 0:
                raise SystemExit(f"{tool}: a change no longer matches "
                                 f"{source.name}: {start.strip()[:60]!r}")
            src = src[:i] + new + src[j:]
        else:
            if old not in src:
                raise SystemExit(f"{tool}: a change no longer matches "
                                 f"{source.name}: {old.strip()[:60]!r}")
            src = src.replace(old, new)
    return src


def ptxas_usage(text: str, key) -> dict:
    """Registers a thread and spill-store bytes by kernel from ``nvcc
    -Xptxas -v`` output: ``key(line)`` names the kernel whose entry
    function a line starts (None on other lines); the largest of each over
    the entries that share a name."""
    usage, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = key(line)
            if name is not None:
                usage.setdefault(name, {"registers": 0,
                                        "spill_store_bytes": 0})
        if name is None:
            continue
        for field, pattern in (("registers", r"Used (\d+) registers"),
                               ("spill_store_bytes",
                                r"(\d+) bytes spill stores")):
            found = re.search(pattern, line)
            if found:
                usage[name][field] = max(usage[name][field],
                                         int(found.group(1)))
    return usage


def build_variants(source, variants: dict, tool: str, key) -> dict:
    """Build every variant of ``source`` at once into
    ``build/torch_ext/<tool>/``; ``{name: (library, ptxas usage)}``."""
    out = build.BUILD_ROOT / tool
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        stem = re.sub(r"[^a-z0-9]+", "_", name.lower())
        cu, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
        cu.write_text(variant_source(source, variants[name], tool))
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                               "-Xptxas", "-v", "-I", str(build.CSRC), "-o",
                               str(lib), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return (ctypes.CDLL(str(lib)),
                ptxas_usage(proc.stdout + proc.stderr, key))
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(one, variants)))


def entry(lib, name: str, argtypes: list):
    """The C function ``name`` of ``lib``, returning an int error code."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def median_ms(fn, reps: int = 7, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def pass_ms(fn, names, inner: int = 10) -> list[float]:
    """Device ms a call of each kernel whose name holds one of ``names``
    (in that order), over ``inner`` profiled calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                total[name] += (e.time_range.end - e.time_range.start) / 1e3
    return [total[name] / inner for name in names]


def rel_err(got, want) -> "float | None":
    """max |got - want| / max |want|, None where that is not finite."""
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    return err if math.isfinite(err) else None


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
