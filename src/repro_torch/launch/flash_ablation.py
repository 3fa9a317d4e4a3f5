"""Where the tensor-core flash attention kernel spends its time, by ablation.

The card's profilers (ncu, nsys) do not run in every sandbox, so this
measures the cost of each phase of ``kernels/csrc/flash_attention_wgmma.cu``
by taking it away: each variant is the kernel's source with one textual
change, built beside the others and timed at the shapes ``chip_smoke.py``
times.  A variant that removes a phase computes a wrong answer; its time
says only what that phase costs.  Two variants change the tiling instead
(a three-stage k/v ring, head_dim 256 in two warpgroups) and stay exact.

    PYTHONPATH=src python -m repro_torch.launch.flash_ablation

Needs a CUDA card and nvcc; builds into ``build/torch_ext/ablation/``.
Prints one line per shape (median ms per call over CUDA-event windows of
10 calls) and ends with a JSON summary and the card's name and power
limit.
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

from repro_torch.kernels import build, ref

SOURCE = build.CSRC / "flash_attention_wgmma.cu"
OUT = build.BUILD_ROOT / "ablation"

# name -> changes to the kernel's text: (old, new) replaces old; a pair of
# texts as old replaces the span from the first up to the second
VARIANTS = {
    "as built": [],
    "no softmax": [(
        ("      float mx[2] = {-INFINITY, -INFINITY};",
         "      // 3. O += P V"),
        "      float alpha[2] = {1.f, 1.f};\n"
        "      uint32_t p[BK / 16][4];            // S's bits stand in for P\n"
        "#pragma unroll\n"
        "      for (int kk = 0; kk < BK / 16; ++kk)\n"
        "#pragma unroll\n"
        "        for (int r = 0; r < 4; ++r)\n"
        "          p[kk][r] = __float_as_uint(s[8 * kk + 2 * r]);\n")],
    "no next-tile loads": [
        ("    if (ahead < t_end) stage_kv(ahead, (ahead - t_begin) % "
         "T::STAGES);", "")],
    "no QK wgmma": [
        ("        mma_ss<BK>(s, sw128_desc(a, 16, 1024), "
         "sw128_desc(bb, 16, 1024),\n                   kk > 0);",
         "        (void)a;\n        (void)bb;")],
    "no PV wgmma": [
        ("        mma_rs<HD>(acc, p[kk],\n                   "
         "sw128_desc(v_tile + kk * 16 * 128, BK * 128, 1024), 1);",
         "        (void)p;")],
    "three-stage ring": [
        ("  static constexpr int STAGES = 2;",
         "  static constexpr int STAGES = HD == 256 ? 2 : 3;")],
    "hd 256 in two warpgroups": [
        ("  static constexpr int NWG = HD == 256 ? 1 : 2;",
         "  static constexpr int NWG = 2;"),
        ("  static constexpr int MIN_BLOCKS = HD == 256 ? 2 : 1;",
         "  static constexpr int MIN_BLOCKS = 1;")],
}
SHAPES = [  # name, b, s, hq, hkv, hd, causal, window
    ("qwen2-7b S=4096 Hq28 Hkv4 hd128 causal", 1, 4096, 28, 4, 128, True,
     None),
    ("gemma-2b S=4096 Hq8 Hkv1 hd256 causal", 1, 4096, 8, 1, 256, True, None),
    ("recurrentgemma-9b S=8192 Hq16 Hkv1 hd256 window 2048", 1, 8192, 16, 1,
     256, True, 2048),
    ("non-causal S=2048 Hq8 Hkv2 hd128", 1, 2048, 8, 2, 128, False, None),
]


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s changes; raises if the
    kernel no longer contains the text a change replaces."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        start, end = old if isinstance(old, tuple) else (old, None)
        i = src.find(start)
        j = i + len(start) if end is None else src.find(end)
        if i < 0 or j < 0:
            raise SystemExit(f"flash_ablation: {name!r} no longer matches "
                             f"{SOURCE.name}: {start.strip()[:60]!r}")
        src = src[:i] + new + src[j:]
    return src


def build_variant(name: str):
    """Build variant ``name`` into OUT; return its C entry and, per padded
    head_dim, the registers a thread and the spill-store bytes ptxas
    reports."""
    stem = name.replace(" ", "_")
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(variant_source(name))
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-I", str(build.CSRC), "-o", str(lib),
                           str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    usage, hd = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '.*kernelILi(\d+)E", line)
        if entry:
            hd = int(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if hd is not None and spill:
            usage.setdefault(hd, {})["spill_store_bytes"] = int(spill.group(1))
        if hd is not None and regs:
            usage.setdefault(hd, {})["registers"] = int(regs.group(1))
    fn = ctypes.CDLL(str(lib)).flash_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, usage


def median_ms(fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    fns = {name: fn for name, (fn, _) in built.items()}
    usage = {name: u for name, (_, u) in built.items()}
    print("registers a thread (spill-store bytes) by padded head_dim, as "
          "built: " + ", ".join(
              f"hd {hd} {u['registers']} ({u['spill_store_bytes']})"
              for hd, u in sorted(usage["as built"].items())), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    summary = {}
    for name, b, s, hq, hkv, hd, causal, window in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, hq, hkv, hd, int(causal), window or 0, 1.0 / hd ** 0.5,
                stream)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        row = {}
        for variant, fn in fns.items():
            if fn(*args) != 0:
                raise RuntimeError(f"{variant} failed to launch at {name}")
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max()
                        / want.float().abs().max())
            row[variant] = {"ms": median_ms(lambda fn=fn: fn(*args)),
                            "rel_err": err if math.isfinite(err) else None}
        summary[name] = row
        print(f"{name}: " + ", ".join(
            f"{vname} {r['ms']:.4f} ms" for vname, r in row.items()),
            flush=True)
        del q, k, v, out, want
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"flash_ablation": summary, "ptxas": usage}))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
