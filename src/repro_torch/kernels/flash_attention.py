"""Launcher for the hand-written Hopper flash attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``flash_attention`` (src/repro/kernels/flash_attention.py): online-softmax
attention with causal and sliding-window masks and grouped-query heads.  No
model path of either package calls it (every attention in
``repro.models`` runs the jnp ``block_causal_attention``), so the port
carries the kernel, its plain version and its dispatch
(``ops.flash_attention``), as the reference does.  This module checks the
operands, allocates the output and launches the kernel on the current CUDA
stream; the kernel picks its own tiles (the TPU wrapper's ``block_q`` and
``block_k`` are tiling only).

``flash_launches`` counts the calls that reach the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand

LIB = "flash_attention"
flash_launches = 0

MAX_HEAD_DIM = 256
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention on the card.

    q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd), Hkv dividing Hq; one dtype,
    f32 or bf16; hd <= 256.  ``window``: keys with q − k ≥ window are
    masked, with or without ``causal``.  Returns (B, S, Hq, hd) in q's dtype.
    """
    global flash_launches
    device = build.cuda_device("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, S, Hq, hd) and k (B, S, Hkv, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in _SYMBOLS:
        raise TypeError(f"q has dtype {q.dtype}, expected one of "
                        f"{tuple(_SYMBOLS)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    check_operand("q", q, (b, s, hq, hd), (q.dtype,), device)
    check_operand("k", k, (b, s, hkv, hd), (q.dtype,), device)
    check_operand("v", v, (b, s, hkv, hd), (q.dtype,), device)
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hkv} kv heads do not divide {hq} query heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.launch("flash_attention", LIB, _SYMBOLS[q.dtype], [q, k, v, out],
                 [b, s, hq, hkv, hd, int(causal),
                  0 if window is None else int(window), 1.0 / hd ** 0.5],
                 device, "flash_attention_error_string")
    flash_launches += 1
    return out
