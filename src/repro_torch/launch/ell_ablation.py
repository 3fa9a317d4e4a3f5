"""Where the ELL / packed aggregation kernel spends its time, by variant.

The card's profilers (ncu, nsys) are not always available, so this
times textual variants of ``kernels/csrc/community_spmm_ell.cu`` against
the kernel as built, at the shapes ``chip_smoke.py`` times: the trainer's
strided ELL pass (k = 3 lanes, 3 slots of 4,584 rows, C = 767 / 1000 / 10,
and C = 1000 with bf16 blocks) and the server's packed halo pass (one lane,
15 live slots of 864 rows, C = 767 / 1000).  Every variant changes only the
tiling, the staging or the code the compiler sees, never the order of the
sum, so each must give the as-built output bit for bit; the script checks
that at every shape.

    PYTHONPATH=src python -m repro_torch.launch.ell_ablation

Needs a CUDA card and nvcc; builds into ``build/torch_ext/ell_ablation/``.
Prints ptxas's registers and spill stores per tile configuration, one line
per shape (median ms per call over CUDA-event windows of 3 calls; the SM
clock and power draw under load at C = 1000), and ends with a JSON summary
and the card's name and power limit.  Exits 1 if a variant's output
differs from the as-built output in any bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "community_spmm_ell.cu"
OUT = build.BUILD_ROOT / "ell_ablation"

_UNROLLED_A = "#pragma unroll\n  for (int r = 0; r < L::BM * ACH"
_UNROLLED_Z = "#pragma unroll\n  for (int r = 0; r < BK * ZCH"
_ROLLED = [(_UNROLLED_A, _UNROLLED_A.replace("unroll", "unroll 1")),
           (_UNROLLED_Z, _UNROLLED_Z.replace("unroll", "unroll 1"))]
_LARGE = "using Large = Tile<128, 128, 8, 8, 3, 1>;"
_SMALL = "using Small = Tile<64, 64, 8, 4, 4, 2>;"
_NARROW = "using Narrow = Tile<64, 16, 4, 1, 4, 3>;"
_MIN_GRID = "constexpr int LARGE_MIN_GRID = 2 * NUM_SMS;"
_COSTS = "constexpr int HALF_COST = 3, SMALL_COST = 5;"
_ROW = "  return i * (L::BM / L::TM) + ty;"


def _large(stages: int, min_blocks: int) -> list:
    return [(_LARGE, f"using Large = Tile<128, 128, 8, 8, {stages}, "
                     f"{min_blocks}>;")]


# name -> (old, new) replacements of the kernel's text
VARIANTS = {
    "as built": [],
    "as built, again": [],
    "large: 2 blocks/SM": _large(3, 2),
    "large: 2 blocks/SM, copy loops rolled": _large(3, 2) + _ROLLED,
    "large: 2 stages": _large(2, 1),
    "large: 4 stages": _large(4, 1),
    "no large tile": [
        (_MIN_GRID, "constexpr int LARGE_MIN_GRID = 1 << 30;")],
    "small: 256 threads, 4x4": [
        (_SMALL, "using Small = Tile<64, 64, 4, 4, 4, 3>;")],
    "no half tile": [
        (_COSTS, "constexpr int HALF_COST = 1 << 20, SMALL_COST = 5;")],
    "half tile wherever not large": [
        (_COSTS, "constexpr int HALF_COST = 0, SMALL_COST = 5;")],
    "rows in groups of 4": [
        (_ROW, "  return (i / 4) * (L::BM * 4 / L::TM) + ty * 4 + i % 4;")],
    "narrow: 8 stages": [
        (_NARROW, "using Narrow = Tile<64, 16, 4, 1, 8, 3>;")],
    "BK 64": [("constexpr int BK = 32;", "constexpr int BK = 64;")],
    "Z copies 4 bytes everywhere": [
        ("  out[10] = (out[1] >= 32 && z_align >= 16) ? 16 : 4;",
         "  out[10] = 4;")],
}


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s changes; raises if the
    kernel no longer contains the text a change replaces."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"ell_ablation: {name!r} no longer matches "
                             f"{SOURCE.name}: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str):
    """Build variant ``name`` into OUT; return its library and, per tile
    configuration and block type, the largest register count a thread and
    spill-store bytes ptxas reports over the copy-width instantiations."""
    stem = re.sub(r"[^a-z0-9]+", "_", name.lower())
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(variant_source(name))
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    usage, key = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '.*TileILi(\d+)ELi(\d+)"
                          r"ELi\d+ELi\d+ELi\d+ELi\d+EEE(13__nv_bfloat16|f)",
                          line)
        if entry:
            key = (f"{entry.group(1)}x{entry.group(2)} "
                   f"{'bf16' if entry.group(3) != 'f' else 'f32'}")
            usage.setdefault(key, {"registers": 0, "spill_store_bytes": 0})
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if key is not None and spill:
            usage[key]["spill_store_bytes"] = max(
                usage[key]["spill_store_bytes"], int(spill.group(1)))
        if key is not None and regs:
            usage[key]["registers"] = max(usage[key]["registers"],
                                          int(regs.group(1)))
    return ctypes.CDLL(str(lib)), usage


def median_ms(fn, reps: int = 5, inner: int = 3) -> float:
    for _ in range(2):
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


def clock_under_load(fn, args, seconds: float = 3.0) -> str:
    """The SM clock and power draw nvidia-smi reads halfway through
    ``seconds`` of back-to-back launches of ``fn(*args)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    for _ in range(max(1, int(seconds * 1e3 / start.elapsed_time(end)))):
        fn(*args)
    time.sleep(seconds / 2)
    read = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return read


def shapes(dev):
    """(name, symbol, operands, k, D, n_pad, C) at the timed shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    k, d, n = 3, 3, 4584
    blocks = torch.randn((k, d, n, n), generator=gen, device=dev)
    idx = torch.arange(d, **i32).repeat(k, 1).contiguous()
    ones = torch.ones((k, d), **i32)
    rows = torch.full((k,), n, **i32)
    nbrs = torch.full((k, d), n, **i32)
    for c, dtype in ((767, "f32"), (1000, "f32"), (10, "f32"),
                     (1000, "bf16")):
        z = torch.randn((k, n, c), generator=gen, device=dev)
        b = blocks if dtype == "f32" else blocks.to(torch.bfloat16)
        yield (f"ELL k=3 D=3 n_pad={n} C={c} {dtype}",
               f"community_spmm_ell_{dtype}", (b, idx, ones, rows, nbrs, z),
               k, d, n, c)
    del blocks
    n_s, d_s = 864, 16
    blocks = torch.randn((1, d_s, n_s, n_s), generator=gen, device=dev)
    off = (torch.arange(d_s, **i32) * n_s)[None].contiguous()
    mask = torch.ones((1, d_s), **i32)
    mask[0, 0] = 0                      # the halo pass: self slot masked
    rows = torch.full((1,), n_s, **i32)
    nbrs = (torch.full((1, d_s), n_s, **i32) * mask).contiguous()
    for c in (767, 1000):
        plane = torch.randn((d_s * n_s, c), generator=gen, device=dev)
        yield (f"packed halo k=1 D=16 (15 live) n_pad={n_s} C={c} f32",
               "community_spmm_ell_packed_f32",
               (blocks, off, mask, rows, nbrs, plane), 1, d_s, n_s, c)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("ell_ablation: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    usage = {name: u for name, (_, u) in built.items()}
    for name, u in usage.items():
        print(f"{name}: registers (spill-store bytes) " + ", ".join(
            f"{key} {v['registers']} ({v['spill_store_bytes']})"
            for key, v in sorted(u.items())), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    summary = {}
    for name, symbol, ops, k, d, n_pad, c in shapes(dev):
        want = None
        row = {}
        for variant, (lib, _) in built.items():
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty((k, n_pad, c), device=dev)
            call = [t.data_ptr() for t in ops] + [out.data_ptr(), k, d,
                                                  n_pad, c, stream]
            if fn(*call) != 0:
                raise RuntimeError(f"{variant} failed to launch at {name}")
            torch.cuda.synchronize()
            if want is None:
                want = out
            row[variant] = {"ms": median_ms(lambda fn=fn, a=call: fn(*a)),
                            "bitwise_as_built": bool(torch.equal(out, want))}
        if "C=1000 f32" in name:
            fn = getattr(built["as built"][0], symbol)
            row["as built"]["clock_under_load"] = clock_under_load(fn, call)
            print(f"{name}: as built, SM clock and power under load "
                  f"{row['as built']['clock_under_load']}", flush=True)
        summary[name] = row
        print(f"{name}: " + ", ".join(
            f"{v} {r['ms']:.3f} ms{'' if r['bitwise_as_built'] else ' DIFF'}"
            for v, r in row.items()), flush=True)
        del want
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"ell_ablation": summary, "ptxas": usage}))
    print(card)
    same = all(r["bitwise_as_built"] for row in summary.values()
               for r in row.values())
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
