"""Where the flash attention kernels spend their time, by ablation.

Measures the cost of each phase of ``kernels/csrc/flash_attention_wgmma.cu``
(bf16, the default) or ``kernels/csrc/flash_attention.cu`` (``--dtype
float32``, the FFMA route) by taking it away: each variant is the kernel's
source with one textual change, built beside the others and timed at the
shapes ``chip_smoke.py`` times.  A variant that removes a phase computes a
wrong answer; its time says only what that phase costs.  The variants that
change the tiling instead (bf16: a three-stage k/v ring, head_dim 256 in
two warpgroups; f32: other register tiles and blocks) stay exact.

    PYTHONPATH=src python -m repro_torch.launch.flash_ablation [--dtype
        bfloat16|float32]

Needs a CUDA card and nvcc; builds into
``build/torch_ext/flash_ablation_<dtype>/``.  Prints one line per shape
(median ms per call over CUDA-event windows of 10 calls) and ends with a
JSON summary and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re

import torch

from repro_torch.kernels import build, ref
from repro_torch.launch import ablation

# name -> changes to the kernel's text: (old, new) replaces old; a pair of
# texts as old replaces the span from the first up to the second
BF16_VARIANTS = {
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
BF16_SHAPES = [  # name, b, s, hq, hkv, hd, causal, window
    ("qwen2-7b S=4096 Hq28 Hkv4 hd128 causal", 1, 4096, 28, 4, 128, True,
     None),
    ("gemma-2b S=4096 Hq8 Hkv1 hd256 causal", 1, 4096, 8, 1, 256, True, None),
    ("recurrentgemma-9b S=8192 Hq16 Hkv1 hd256 window 2048", 1, 8192, 16, 1,
     256, True, 2048),
    ("non-causal S=2048 Hq8 Hkv2 hd128", 1, 2048, 8, 2, 128, False, None),
]

F32_VARIANTS = {
    "as built": [],
    "no q.k^T": [("    for (int d0 = 0; d0 < hd16; d0 += 16) {",
                  "    for (int d0 = 0; d0 < 0; d0 += 16) {")],
    "P.v: loads, 1 FMA of 4": [
        ("            axpy4(acc[i][cm], pv[i / 4].x, vv);\n"
         "            axpy4(acc[i + 1][cm], pv[i / 4].y, vv);\n"
         "            axpy4(acc[i + 2][cm], pv[i / 4].z, vv);\n"
         "            axpy4(acc[i + 3][cm], pv[i / 4].w, vv);",
         "            acc[i][cm].x += pv[i / 4].x * vv.x;\n"
         "            acc[i + 1][cm].x += pv[i / 4].y * vv.x;\n"
         "            acc[i + 2][cm].x += pv[i / 4].z * vv.x;\n"
         "            acc[i + 3][cm].x += pv[i / 4].w * vv.x;")],
    "no P.v": [("    for (int jr = 0; jr < KJ; jr += 2) {",
                "    for (int jr = 0; jr < 0; jr += 2) {")],
    "hd 128 in 4 x 8 tiles (BK 64, 8 lanes a row)": [
        ("  static constexpr int BQ = 128, BK = 128, TX = 16;",
         "  static constexpr int BQ = 128, BK = 64, TX = 8;")],
    "hd 128 in 64-row blocks": [
        ("  static constexpr int BQ = 128, BK = 128, TX = 16;",
         "  static constexpr int BQ = 64, BK = 128, TX = 16;")],
    "hd 64 one block an SM": [
        ("__global__ void __launch_bounds__(THREADS, HD == 64 ? 2 : 1)",
         "__global__ void __launch_bounds__(THREADS, 1)")],
}
F32_SHAPES = [  # name, b, s, hq, hkv, hd, causal, window
    ("qwen2-7b heads S=2048 Hq28 Hkv4 hd128 causal", 1, 2048, 28, 4, 128,
     True, None),
    ("gemma-2b heads S=2048 Hq8 Hkv1 hd256 causal", 1, 2048, 8, 1, 256, True,
     None),
    ("2x4096 Hq8 Hkv2 hd64 causal", 2, 4096, 8, 2, 64, True, None),
]
# dtype -> (source, C entry, variants, shapes)
ROUTES = {
    "bfloat16": ("flash_attention_wgmma.cu", "flash_attention_bf16",
                 BF16_VARIANTS, BF16_SHAPES),
    "float32": ("flash_attention.cu", "flash_attention_f32", F32_VARIANTS,
                F32_SHAPES),
}


def kernel_name(line: str) -> "str | None":
    """The flash kernel, by padded head_dim, whose entry function a ptxas
    line starts."""
    found = re.search(r"Compiling entry function '.*kernelILi(\d+)E", line)
    return f"hd {found.group(1)}" if found else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(ROUTES), default="bfloat16")
    dtype_name = parser.parse_args(argv).dtype
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation: needs a CUDA card")
    source, entry_name, variants, shapes = ROUTES[dtype_name]
    built = ablation.build_variants(build.CSRC / source, variants,
                                    f"flash_ablation_{dtype_name}",
                                    kernel_name)
    fns = {name: ablation.entry(lib, entry_name, [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 7
                                + [ctypes.c_float, ctypes.c_void_p])
           for name, (lib, _) in built.items()}
    usage = {name: u for name, (_, u) in built.items()}
    print("registers a thread (spill-store bytes) by padded head_dim, as "
          "built: " + ", ".join(
              f"{hd} {u['registers']} ({u['spill_store_bytes']})"
              for hd, u in sorted(usage["as built"].items())), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    summary = {}
    for name, b, s, hq, hkv, hd, causal, window in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
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
            row[variant] = {"ms": ablation.median_ms(lambda fn=fn: fn(*args)),
                            "rel_err": ablation.rel_err(out, want)}
        summary[name] = row
        print(f"{name}: " + ", ".join(
            f"{vname} {r['ms']:.4f} ms (rel err {r['rel_err']})"
            for vname, r in row.items()), flush=True)
        del q, k, v, out, want
    print(json.dumps({"flash_ablation": summary, "dtype": dtype_name,
                      "ptxas": usage}))
    print(ablation.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
