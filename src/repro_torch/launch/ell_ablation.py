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
import subprocess
import time

import torch

from repro_torch.kernels import build
from repro_torch.launch import ablation

SOURCE = build.CSRC / "community_spmm_ell.cu"
# the C entries: seven operand pointers, k, D, n_pad, C, the stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

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


def tile_name(line: str) -> "str | None":
    """The tile configuration and block type whose entry function a ptxas
    line starts (the copy-width instantiations of one share a name)."""
    found = re.search(r"Compiling entry function '.*TileILi(\d+)ELi(\d+)"
                      r"ELi\d+ELi\d+ELi\d+ELi\d+EEE(13__nv_bfloat16|f)",
                      line)
    if found is None:
        return None
    return (f"{found.group(1)}x{found.group(2)} "
            f"{'bf16' if found.group(3) != 'f' else 'f32'}")


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
    built = ablation.build_variants(SOURCE, VARIANTS, "ell_ablation",
                                    tile_name)
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
            fn = ablation.entry(lib, symbol, ARGTYPES)
            out = torch.empty((k, n_pad, c), device=dev)
            call = [t.data_ptr() for t in ops] + [out.data_ptr(), k, d,
                                                  n_pad, c, stream]
            if fn(*call) != 0:
                raise RuntimeError(f"{variant} failed to launch at {name}")
            torch.cuda.synchronize()
            if want is None:
                want = out
            row[variant] = {"ms": ablation.median_ms(
                                lambda fn=fn, a=call: fn(*a), reps=5,
                                inner=3, warmup=2),
                            "bitwise_as_built": bool(torch.equal(out, want))}
        if "C=1000 f32" in name:
            fn = ablation.entry(built["as built"][0], symbol, ARGTYPES)
            row["as built"]["clock_under_load"] = clock_under_load(fn, call)
            print(f"{name}: as built, SM clock and power under load "
                  f"{row['as built']['clock_under_load']}", flush=True)
        summary[name] = row
        print(f"{name}: " + ", ".join(
            f"{v} {r['ms']:.3f} ms{'' if r['bitwise_as_built'] else ' DIFF'}"
            for v, r in row.items()), flush=True)
        del want
    print(json.dumps({"ell_ablation": summary, "ptxas": usage}))
    print(ablation.card())
    same = all(r["bitwise_as_built"] for row in summary.values()
               for r in row.values())
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
