"""Where the SSD scan kernels spend their time, by ablation.

Measures the cost of each part of ``kernels/csrc/ssd_scan_wgmma.cu`` (bf16,
the default) or ``kernels/csrc/ssd_scan.cu`` (``--dtype float32``, the
FFMA route) by taking it away: each variant is the kernel's source with one
textual change, built beside the others and timed at the shapes
``chip_smoke.py`` times (Mamba-2 1.3B's scan: 64 heads, head_dim 64,
d_state 128, chunk 256; 4 x 4096 and 1 x 32768 tokens).  A variant that
removes a part computes a wrong answer; its time says only what that part
costs.  Each pass's device time comes from ``torch.profiler`` (the kernels
by name), the call's from CUDA events.

    PYTHONPATH=src python -m repro_torch.launch.ssd_ablation [--dtype
        bfloat16|float32]

Needs a CUDA card and nvcc; builds into
``build/torch_ext/ssd_ablation_<dtype>/``.  Prints one line per variant and
shape (ms per call over windows of 10 calls: the call, then passes 1-3) and
ends with a JSON summary and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re

import torch

from repro_torch.kernels import build, ref
from repro_torch.launch import ablation

_P1_MMA = ("    mma_ss<64, 1, 1>(d, sw128_desc(bw_s + wgi * BLOCK + step, "
           "BLOCK, 1024),\n"
           "                     sw128_desc(x_s + step, BLOCK, 1024), "
           "kk > 0);")
_P3_STATE_MMA = ("        mma_ss<64, 0, 1>(\n            acc,")
_P3_SCORE_MMA = ("      mma_ss<64>(s, sw128_desc(c_s + off + t0 * 128, 16, "
                 "1024),")
_P3_PV_MMA = "      mma_rs<64>(acc, p[kk],"

# name -> (old, new) replacements of the kernel's text, by route
BF16_VARIANTS = {
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
F32_VARIANTS = {
    "as built": [],
    "pass 1: no FMAs": [("    for (int u = 0; u < ROWS1; ++u) {",
                         "    for (int u = 0; u < 0; ++u) {")],
    "pass 3: no scores": [
        ("    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;\n"
         "  for (int n0 = 0; n0 < n16; n0 += 16) {",
         "    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;\n"
         "  for (int n0 = 0; n0 < 0; n0 += 16) {")],
    "pass 3: no scores.x": [
        ("  for (int ub = 0; ub < TILE / 16; ++ub) {",
         "  for (int ub = 0; ub < 0; ++ub) {")],
    "pass 3: no entering-state term": [
        ("    if (c > 0 || ti > 0) {", "    if (false) {")],
    "pass 3: no state update": [
        ("    if (more) {\n      const int tn",
         "    if (false) {\n      const int tn")],
}
# dtype -> (source, C entry, variants, the passes' kernel names)
ROUTES = {
    "bfloat16": ("ssd_scan_wgmma.cu", "ssd_scan_bf16", BF16_VARIANTS,
                 ("ssd_chunk_states", "ssd_state_passing",
                  "ssd_chunk_output")),
    "float32": ("ssd_scan.cu", "ssd_scan_f32", F32_VARIANTS,
                ("ssd_f32_chunk_states", "ssd_state_passing",
                 "ssd_f32_chunk_output")),
}
SHAPES = [(4, 4096), (1, 32768)]   # batch x tokens; H 64, P 64, N 128
INNER = 10


def kernel_name(line: str) -> "str | None":
    """The SSD kernel whose entry function a ptxas line starts."""
    found = re.search(r"Compiling entry function '.*?(ssd_\w+?)(?:E|I)", line)
    return found.group(1) if found else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(ROUTES), default="bfloat16")
    dtype_name = parser.parse_args(argv).dtype
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablation: needs a CUDA card")
    source, entry_name, variants, passes = ROUTES[dtype_name]
    built = ablation.build_variants(build.CSRC / source, variants,
                                    f"ssd_ablation_{dtype_name}", kernel_name)
    print(f"registers a thread (spill-store bytes), as built: "
          + ", ".join(f"{fn} {u['registers']} ({u['spill_store_bytes']})"
                      for fn, u in built["as built"][1].items()), flush=True)
    fns = {name: ablation.entry(lib, entry_name, [ctypes.c_void_p] * 10
                                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
           for name, (lib, _) in built.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    h, p, g, n, chunk = 64, 64, 1, 128, 256
    summary = {}
    for b, s in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x, bm, cm = (randn(*shape).to(dtype)
                     for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
        dt, a = 0.5 * randn(b, s, h).abs(), -randn(h).abs()
        nc = s // chunk
        y = torch.empty_like(x)
        # S_c in f32, the entering states in x's dtype, cum, decay
        scratch = [torch.empty((b, h, nc, n, p), device=dev),
                   torch.empty((b, h, nc, n, p), dtype=dtype, device=dev),
                   torch.empty((b, h, s), device=dev),
                   torch.empty((b, h, nc), device=dev)]
        args = [t.data_ptr() for t in (x, dt, a, bm, cm, y, *scratch)] + [
            b, s, h, p, g, n, chunk, stream]
        want = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
        row = {}
        for variant, fn in fns.items():
            if fn(*args) != 0:
                raise RuntimeError(f"{variant} failed to launch at {b}x{s}")
            torch.cuda.synchronize()
            row[variant] = {
                "ms": ablation.median_ms(lambda fn=fn: fn(*args), reps=5,
                                         inner=INNER, warmup=2),
                "pass_ms": ablation.pass_ms(lambda fn=fn: fn(*args), passes,
                                            inner=INNER),
                "rel_err": ablation.rel_err(y, want)}
            r = row[variant]
            print(f"{b}x{s} {variant}: {r['ms']:.4f} ms; passes "
                  + " / ".join(f"{v:.4f}" for v in r["pass_ms"])
                  + f" ms; rel err {r['rel_err']}", flush=True)
        summary[f"{b}x{s}"] = row
        del x, bm, cm, dt, y, scratch, want
    print(json.dumps({"ssd_ablation": summary, "dtype": dtype_name,
                      "ptxas": built["as built"][1]}))
    print(ablation.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
