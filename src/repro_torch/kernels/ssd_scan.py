"""Launcher for the hand-written Hopper Mamba-2 SSD scan kernel.

``csrc/ssd_scan.cu`` replaces the Pallas TPU kernel ``ssd_scan``
(src/repro/kernels/ssd_scan.py): the chunked dual form of the SSD scan with
the (P × N) state carried across chunks.  This module checks the operands,
allocates the output and launches the kernel on the current CUDA stream
through the library ``build.load`` compiles at first use.  The model path
is inference only (the reference's kernel has no VJP), so there is no
``autograd.Function``.

``ssd_launches`` counts the calls that reach the kernel; a caller that wants
the count of one phase resets it to 0 before the phase.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand
from repro_torch.kernels.ref import ssd_chunk_length

LIB = "ssd_scan"
ssd_launches = 0

# one block holds a chunk's 64-row tiles and the (N, P) f32 state in
# shared memory: chunk <= 256, head_dim <= 64, d_state <= 128
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """The SSD scan on the card.

    x:     (B, S, H, P) f32 or bf16
    dt:    (B, S, H) f32
    a:     (H,) f32, negative
    b_mat: (B, S, G, N), c_mat: (B, S, G, N), x's dtype; G divides H
    chunk: as the TPU kernel takes it: min(chunk, S), halved until it
           divides S (``ref.ssd_chunk_length``)
    returns y (B, S, H, P) in x's dtype
    """
    global ssd_launches
    device = build.cuda_device("ssd_scan", x)
    if x.dim() != 4 or b_mat.dim() != 4:
        raise ValueError(f"expected x (B, S, H, P) and b_mat (B, S, G, N), "
                         f"got {tuple(x.shape)} and {tuple(b_mat.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(_SYMBOLS)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    check_operand("x", x, (bsz, s, h, p), (x.dtype,), device)
    check_operand("dt", dt, (bsz, s, h), (torch.float32,), device)
    check_operand("a", a, (h,), (torch.float32,), device)
    check_operand("b_mat", b_mat, (bsz, s, g, n), (x.dtype,), device)
    check_operand("c_mat", c_mat, (bsz, s, g, n), (x.dtype,), device)
    if g < 1 or h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    length = ssd_chunk_length(s, chunk)
    if length > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, head_dim "
                         f"<= {MAX_HEAD_DIM} and d_state <= {MAX_STATE}; got "
                         f"{length}, {p} and {n}")
    build.launch("ssd_scan", LIB, _SYMBOLS[x.dtype],
                 [x, dt, a, b_mat, c_mat, y], [bsz, s, h, p, g, n, length],
                 device, "ssd_scan_error_string")
    ssd_launches += 1
    return y
