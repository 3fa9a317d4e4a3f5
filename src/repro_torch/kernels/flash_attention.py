"""Launcher for the hand-written Hopper flash attention kernels.

Two CUDA kernels replace the Pallas TPU kernel ``flash_attention``
(src/repro/kernels/flash_attention.py): online-softmax attention with causal
and sliding-window masks and grouped-query heads.  The route is fixed by the
operands' dtype, not chosen on failure:

* bf16 runs ``csrc/flash_attention_wgmma.cu``, on the tensor cores (wgmma);
* f32 runs ``csrc/flash_attention.cu``, an FFMA kernel: register tiles of
  scores and output (8 × 8 at head_dim 128), P parked in shared memory
  for P·v, k and v copied by ``cp.async`` behind the product that does
  not read them, longest causal tiles first (tensor cores in f32 would
  mean TF32, outside the f32 limit of 1e-5 of max).

The reference's models run the jnp ``block_causal_attention`` and never
this kernel; the port's models call it (through ``ops.flash_attention``)
for every full-sequence self-attention under ``use_kernel=True``
(``models.attention.attend``), and run the plain route otherwise.  This
module checks the
operands, allocates the output and launches on the current CUDA stream; the
kernels pick their own tiles (the TPU wrapper's ``block_q`` and ``block_k``
are tiling only); ``tc_layout`` and ``ffma_layout`` mirror the tensor-core
and the FFMA kernel's choices.

Both kernels take a query slice at an offset (``q_offset``): q holds S_q
rows at key positions q_offset .. q_offset + S_q − 1 of k and v's S_k, the
causal and window masks read those positions (a rank of a context-parallel
attention, ``models.attention.gqa_forward_ranks``).  Offset 0 with S_q = S_k
is the whole sequence, the same launch as before the offset existed.

``flash_launches`` counts every call that reaches a kernel,
``flash_tc_launches`` those that reach the tensor-core kernel and
``flash_offset_launches`` those at a query offset other than 0;
``flash_heads`` counts the launches by their number of query heads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand

LIB = "flash_attention"             # f32, FFMA
TC_LIB = "flash_attention_wgmma"    # bf16, tensor cores
flash_launches = 0
flash_tc_launches = 0
flash_offset_launches = 0
flash_heads: dict[int, int] = {}

MAX_HEAD_DIM = 256
_ROUTES = {torch.float32: (LIB, "flash_attention_f32",
                           "flash_attention_error_string"),
           torch.bfloat16: (TC_LIB, "flash_attention_bf16",
                            "flash_attention_wgmma_error_string")}
OFFSET = "_offset"      # the entries that take S_q, S_k and the offset


def tc_layout(hd: int) -> dict:
    """The tensor-core kernel's tiles at head_dim ``hd`` (1..256), as
    ``flash_attention_bf16_layout`` in the CUDA source computes them: the
    head_dim padded to a multiple of 64, query rows per block (64 per
    consumer warpgroup: two, or one at hd 256), keys per kv tile (128 up
    to hd 128, 64 at 192, 32 at 256), threads and shared-memory bytes (q,
    two stages of k and v, 1024 to align)."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")
    head = -(-hd // 64) * 64
    warpgroups = 1 if head == 256 else 2
    block_q = 64 * warpgroups
    block_k = {256: 32, 192: 64}.get(head, 128)
    smem = 2 * head * (block_q + 4 * block_k) + 1024
    return {"head_pad": head, "block_q": block_q, "block_k": block_k,
            "threads": 128 * warpgroups, "smem_bytes": smem}


def ffma_layout(hd: int) -> dict:
    """The FFMA (f32) kernel's tiles at head_dim ``hd`` (1..256), as
    ``flash_attention_f32_layout`` in the CUDA source computes them: the
    head_dim padded to 64, 128 or 256; query rows a block, keys a kv tile
    and lanes sharing a query row (128, 64, 8 at 64; 128, 128, 16 at 128;
    64, 64, 16 at 256); 256 threads; shared-memory bytes (q and k, rows
    padded by 4 floats, v, and P for two keys a lane, rows padded by 4
    floats); each thread's query rows and keys.  The grid is (batch × Hq,
    ⌈S_q / block_q⌉), the query tiles walked from the last when causal."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")
    head = 64 if hd <= 64 else 128 if hd <= 128 else 256
    block_q, block_k, lanes = {64: (128, 64, 8), 128: (128, 128, 16),
                               256: (64, 64, 16)}[head]
    smem = 4 * ((block_q + block_k) * (head + 4) + block_k * head
                + 2 * lanes * (block_q + 4))
    return {"head_pad": head, "block_q": block_q, "block_k": block_k,
            "threads": 256, "smem_bytes": smem,
            "rows_per_thread": block_q * lanes // 256,
            "keys_per_thread": block_k // lanes, "lanes_per_row": lanes}


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None, device: torch.device,
                   q_offset: int = 0) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take; return (B, S_q, Hq, Hkv,
    hd)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, S, Hq, hd) and k (B, S, Hkv, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in _ROUTES:
        raise TypeError(f"q has dtype {q.dtype}, expected one of "
                        f"{tuple(_ROUTES)}")
    b, s, hq, hd = q.shape
    s_k, hkv = k.shape[1], k.shape[2]
    check_operand("q", q, (b, s, hq, hd), (q.dtype,), device)
    check_operand("k", k, (b, s_k, hkv, hd), (q.dtype,), device)
    check_operand("v", v, (b, s_k, hkv, hd), (q.dtype,), device)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hkv} kv heads do not divide {hq} query heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    return b, s, hq, hkv, hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention on the card.

    q: (B, S_q, Hq, hd); k, v: (B, S_k, Hkv, hd), Hkv dividing Hq; one
    dtype, bf16 (tensor cores) or f32 (FFMA); hd <= 256.  Query row r sits
    at key position ``q_offset`` + r.  ``window``: keys with position
    q − k ≥ window are masked, with or without ``causal``.  Returns
    (B, S_q, Hq, hd) in q's dtype.
    """
    global flash_launches, flash_tc_launches, flash_offset_launches
    device = build.cuda_device("flash_attention", q)
    b, s, hq, hkv, hd = check_operands(q, k, v, window, device, q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, symbol, errors = _ROUTES[q.dtype]
    extent = [s]
    if q_offset or k.shape[1] != s:
        symbol, extent = symbol + OFFSET, [s, k.shape[1], int(q_offset)]
    build.launch("flash_attention", lib, symbol, [q, k, v, out],
                 [b, *extent, hq, hkv, hd, int(causal),
                  0 if window is None else int(window), 1.0 / hd ** 0.5],
                 device, errors)
    flash_launches += 1
    flash_heads[hq] = flash_heads.get(hq, 0) + 1
    if lib == TC_LIB:
        flash_tc_launches += 1
    if q_offset:
        flash_offset_launches += 1
    return out
