"""Time the SSD scan and flash attention kernels of one checkout of the port.

    python scripts/time_lm_kernels.py [--src PATH]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
builds its kernels and prints one JSON line: for each shape, the median ms
a call over CUDA-event windows of 10 calls of ``ops.ssd_scan`` or
``ops.flash_attention`` (the launch a model makes), timed by phase 9's
timer (``chip_smoke.median_ms`` of this checkout), with the card's name
and power limit.  Run it on two checkouts in turns (parent, change,
change, parent) inside one call on the card to compare them there; each
checkout builds into its own ``build/torch_ext``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

# (kernel, name, shape): SSD (B, S, H, P, G, N, dtype), chunk 256; flash
# (B, S, Hq, Hkv, hd, causal, window, dtype)
SHAPES = [
    ("ssd", "4x4096 bf16", (4, 4096, 64, 64, 1, 128, "bfloat16")),
    ("ssd", "4x4096 f32", (4, 4096, 64, 64, 1, 128, "float32")),
    ("ssd", "1x32768 f32", (1, 32768, 64, 64, 1, 128, "float32")),
    ("flash", "qwen2-7b heads S=2048 f32",
     (1, 2048, 28, 4, 128, True, None, "float32")),
    ("flash", "gemma-2b heads S=2048 f32",
     (1, 2048, 8, 1, 256, True, None, "float32")),
]
INNER = 10
ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    src = parser.parse_args(argv).src
    sys.path[:0] = [src, str(ROOT)]
    import torch

    from chip_smoke import card_line, median_ms

    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        raise SystemExit("time_lm_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    out = {}
    for kernel, name, shape in SHAPES:
        if kernel == "ssd":
            b, s, h, p, g, n, dtype = shape
            dtype = getattr(torch, dtype)
            args = (randn(b, s, h, p).to(dtype), 0.5 * randn(b, s, h).abs(),
                    -randn(h).abs(), randn(b, s, g, n).to(dtype),
                    randn(b, s, g, n).to(dtype))
            out[name] = median_ms(lambda: ops.ssd_scan(*args, chunk=256), 7,
                                  warmup=3, inner=INNER)
        else:
            b, s, hq, hkv, hd, causal, window, dtype = shape
            dtype = getattr(torch, dtype)
            q, k, v = (randn(*sh).to(dtype) for sh in
                       ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
            out[name] = median_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window), 7, warmup=3,
                inner=INNER)
        torch.cuda.empty_cache()
    print(json.dumps({"src": src, "ms": out, "card": card_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
