"""Where the tensor-core SSD scan spends its time, by ablation.

The card's profilers (ncu, nsys) do not run in every sandbox, so this
measures the cost of each part of ``kernels/csrc/ssd_scan_wgmma.cu`` by
taking it away: each variant is the kernel's source with one textual
change, built beside the others and timed at the shapes ``chip_smoke.py``
times (Mamba-2 1.3B's scan: 64 heads, head_dim 64, d_state 128, chunk 256;
4 x 4096 and 1 x 32768 tokens).  A variant that removes a part computes a
wrong answer; its time says only what that part costs.  Each pass's device
time comes from ``torch.profiler`` (the kernels by name), the call's from
CUDA events.

    PYTHONPATH=src python -m repro_torch.launch.ssd_ablation

Needs a CUDA card and nvcc; builds into ``build/torch_ext/ssd_ablation/``.
Prints one line per variant and shape (ms per call over windows of 10
calls: the call, then passes 1-3) and ends with a JSON summary and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build, ref

SOURCE = build.CSRC / "ssd_scan_wgmma.cu"
OUT = build.BUILD_ROOT / "ssd_ablation"
PASSES = ("ssd_chunk_states", "ssd_state_passing", "ssd_chunk_output")
INNER = 10

_P1_MMA = ("    mma_ss<64, 1, 1>(d, sw128_desc(bw_s + wgi * BLOCK + step, "
           "BLOCK, 1024),\n"
           "                     sw128_desc(x_s + step, BLOCK, 1024), "
           "kk > 0);")
_P3_STATE_MMA = ("        mma_ss<64, 0, 1>(\n            acc,")
_P3_SCORE_MMA = ("      mma_ss<64>(s, sw128_desc(c_s + off + t0 * 128, 16, "
                 "1024),")
_P3_PV_MMA = "      mma_rs<64>(acc, p[kk],"

# name -> (old, new) replacements of the kernel's text
VARIANTS = {
    "as built": [],
    "pass 1: no copies": [
        ("  if (!last) {       // the copies fly while the scan runs",
         "  if (false) {")],
    "pass 1: no B scaling": [
        ("  scale_rows<128, P1_THREADS>(bw_s, BLOCK, chunk, w);", "")],
    "pass 1: no wgmma": [(_P1_MMA, "    (void)step;")],
    "pass 3: no copies": [
        ("  stage<128, P3_THREADS>(c_s, BLOCK, cb, bc_step, TILE * n_tiles, "
         "chunk,\n                         n_dim, vec_bc);", ""),
        ("  if (c > 0)\n    stage<64, P3_THREADS>(in_s,",
         "  if (false)\n    stage<64, P3_THREADS>(in_s,"),
        ("    if (u < n_tiles) {", "    if (false) {")],
    "pass 3: no carried state": [
        ("    if (ui == 0 && c > 0) {", "    if (false) {")],
    "pass 3: no score transform": [
        ("          v[cc] = (t - t0 < tn && u <= t)\n"
         "                      ? s[4 * j + 2 * hh + cc]\n"
         "                            * exp2_approx(cum2[t] - cum2[u]) * "
         "dts[u]\n"
         "                      : 0.f;",
         "          v[cc] = s[4 * j + 2 * hh + cc] + (float)u;")],
    "pass 3: no wgmma (nor the score transform it feeds)": [
        (_P3_STATE_MMA, "        if (kk < 0) mma_ss<64, 0, 1>(\n"
                        "            acc,"),
        (_P3_SCORE_MMA, "      if (kk < 0) mma_ss<64>(s, sw128_desc(c_s + "
                        "off + t0 * 128, 16, 1024),"),
        (_P3_PV_MMA, "      if (kk < 0) mma_rs<64>(acc, p[kk],")],
}
SHAPES = [(4, 4096), (1, 32768)]   # batch x tokens; H 64, P 64, N 128


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s changes; raises if the
    kernel no longer contains the text a change replaces."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"ssd_ablation: {name!r} no longer matches "
                             f"{SOURCE.name}: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str):
    """Build variant ``name`` into OUT; return its C entry and, per pass,
    the registers a thread ptxas reports."""
    stem = re.sub(r"[^a-z0-9]+", "_", name.lower())
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(variant_source(name))
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-I", str(build.CSRC), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    usage, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '.*?(ssd_\w+?)E", line)
        if entry:
            kernel = entry.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if kernel is not None and regs:
            usage[kernel] = int(regs.group(1))
    fn = ctypes.CDLL(str(lib)).ssd_scan_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, usage


def median_ms(fn, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def pass_ms(fn) -> list[float]:
    """Device ms per call of each pass over INNER profiled calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(INNER):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(PASSES, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in PASSES:
            if name in e.name:
                total[name] += (e.time_range.end - e.time_range.start) / 1e3
    return [total[name] / INNER for name in PASSES]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablation: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    print(f"registers a thread, as built: {built['as built'][1]}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    h, p, g, n, chunk = 64, 64, 1, 128, 256
    summary = {}
    for b, s in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x, bm, cm = (randn(*shape).to(torch.bfloat16)
                     for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
        dt, a = 0.5 * randn(b, s, h).abs(), -randn(h).abs()
        nc = s // chunk
        y = torch.empty_like(x)
        scratch = [torch.empty((b, h, nc, n, p), device=dev),
                   torch.empty((b, h, nc, n, p), dtype=torch.bfloat16,
                               device=dev),
                   torch.empty((b, h, s), device=dev),
                   torch.empty((b, h, nc), device=dev)]
        args = [t.data_ptr() for t in (x, dt, a, bm, cm, y, *scratch)] + [
            b, s, h, p, g, n, chunk, stream]
        want = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk).float()
        row = {}
        for variant, (fn, _) in built.items():
            if fn(*args) != 0:
                raise RuntimeError(f"{variant} failed to launch at {b}x{s}")
            torch.cuda.synchronize()
            err = float((y.float() - want).abs().max() / want.abs().max())
            row[variant] = {"ms": median_ms(lambda fn=fn: fn(*args)),
                            "pass_ms": pass_ms(lambda fn=fn: fn(*args)),
                            "rel_err": err if math.isfinite(err) else None}
            r = row[variant]
            print(f"{b}x{s} {variant}: {r['ms']:.4f} ms; passes "
                  + " / ".join(f"{v:.4f}" for v in r["pass_ms"])
                  + f" ms; rel err {r['rel_err']}", flush=True)
        summary[f"{b}x{s}"] = row
        del x, bm, cm, dt, y, scratch, want
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"ssd_ablation": summary,
                      "registers": built["as built"][1]}))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
