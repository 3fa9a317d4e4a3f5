#!/usr/bin/env python3
"""Measure the scratch that the card's softmax backward allocates beside
its output, which ``analysis.memory.MemoryTracker`` (a dispatch mode)
cannot see and so counts from ``memory.SCRATCH``.

    python3 scripts/softmax_scratch.py

For f32 and bf16 and last dims from 16 to 32,768 it prints the peak of
one ``aten._softmax_backward_data`` call above its inputs, in units of
its output's bytes, with a contiguous gradient and with a strided one
(the transpose of a contiguous tensor, as a permuted einsum gradient
reaches the attention's softmax), then the card's name and power limit.
The tracker's rule: the output, one output-sized buffer (grad · output)
and, for a strided gradient, its contiguous copy.  Needs one CUDA device.
"""
import subprocess
import sys

import torch

SHAPES = ((65536, 16), (16384, 64), (8192, 1024), (8192, 1025),
          (4096, 2048), (4096, 4096), (1024, 32768))


def peak_over_inputs(grad: torch.Tensor, out: torch.Tensor) -> float:
    """The call's peak above its inputs, in units of the output."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = torch.ops.aten._softmax_backward_data(grad, out, -1, out.dtype)
    torch.cuda.synchronize()
    del res
    return (torch.cuda.max_memory_allocated() - base) \
        / (out.numel() * out.element_size())


def main() -> int:
    if not torch.cuda.is_available():
        print("softmax_scratch: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        for rows, dim in SHAPES:
            out = torch.softmax(torch.randn((rows, dim), device=dev),
                                -1).to(dt)
            dense = peak_over_inputs(torch.randn_like(out), out)
            strided = peak_over_inputs(
                torch.randn((dim, rows), device=dev, dtype=dt).t(), out)
            print(f"{str(dt).removeprefix('torch.')} {rows} x {dim}: peak "
                  f"above the inputs {dense:g} x the output (contiguous "
                  f"grad), {strided:g} x (strided grad)", flush=True)
            del out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
