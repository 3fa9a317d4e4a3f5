"""Launcher for the hand-written Hopper Mamba-2 SSD scan kernels.

Two CUDA kernels replace the Pallas TPU kernel ``ssd_scan``
(src/repro/kernels/ssd_scan.py): the chunked dual form of the SSD scan with
the (N × P) state carried across chunks.  The route is fixed by the
operands' dtype, not chosen on failure:

* bf16 runs ``csrc/ssd_scan_wgmma.cu`` on the tensor cores (wgmma);
* f32 runs ``csrc/ssd_scan.cu`` on the CUDA cores (FFMA; tensor cores in
  f32 would mean TF32, outside the f32 limit of 1e-4).

Both split the scan into three kernels launched in order: chunk states in
parallel, the state passed across chunks (``csrc/ssd_state.cuh``, one
template for both: the entering state is bf16 on the tensor-core route,
f32 on the FFMA route), then each chunk's output.  This module checks the
operands, allocates the output and the scratch (the chunk states, the
state entering each chunk, the within-chunk cumulative decay and each
chunk's total decay), and launches on the current CUDA stream through the
libraries ``build.load`` compiles at first use.  The model path is
inference only (the reference's kernel has no VJP), so there is no
``autograd.Function``.

``ssd_launches`` counts every call that reaches a kernel, ``ssd_tc_launches``
those that reach the tensor-core kernel, ``ssd_heads`` the launches by
their number of heads; a caller that wants the count of one phase resets
them to 0 before the phase.  ``tc_layout`` and ``ffma_layout`` mirror the
two routes' grids and shared memory (``ssd_scan_wgmma_layout``,
``ssd_scan_f32_layout``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand
from repro_torch.kernels.ref import ssd_chunk_length

LIB = "ssd_scan"                # f32, FFMA
TC_LIB = "ssd_scan_wgmma"       # bf16, tensor cores
ssd_launches = 0
ssd_tc_launches = 0
ssd_heads: dict[int, int] = {}

# both kernels hold a chunk's 64-row tiles and an (N, P) state in shared
# memory: chunk <= 256, head_dim <= 64, d_state <= 128
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
_ROUTES = {torch.float32: (LIB, "ssd_scan_f32", "ssd_scan_error_string"),
           torch.bfloat16: (TC_LIB, "ssd_scan_bf16",
                            "ssd_scan_wgmma_error_string")}
# the tensor-core route's blocks, one per chunk in passes 1 and 3: chunk
# states 256 threads (two warpgroups; 256 rows of B·w, two 128-byte
# column blocks, and of x; 1 KB to align), state passing a thread per
# state element in blocks of 256, output 512 threads (a warpgroup per
# 64-row tile; C, B and x of the chunk and its entering state)
_PASS2_THREADS, _PASS3_THREADS = 256, 512
_PASS1_SMEM = 3 * MAX_CHUNK * 128 + 1024
_PASS3_SMEM = 5 * MAX_CHUNK * 128 + MAX_STATE * 128 + 1024
# the FFMA route's blocks, one per chunk in passes 1 and 3: chunk states
# 128 threads, a ring of two 32-row stages of B and x; output 256
# threads, the chunk's 64-row tiles in turn: the state entering the tile,
# two stages of C_T, B_T (rows padded by 4 floats) and x_T, the scores
# (padded)
_FFMA_PASS1_THREADS, _FFMA_PASS3_THREADS = 128, 256
_FFMA_PASS1_SMEM = 4 * 2 * 32 * (MAX_STATE + MAX_HEAD_DIM)
_FFMA_PASS3_SMEM = 4 * (MAX_STATE * MAX_HEAD_DIM
                        + 2 * 64 * (MAX_STATE + MAX_STATE + 4 + MAX_HEAD_DIM)
                        + 64 * (64 + 4))


def tc_layout(b: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The tensor-core route's three launches at (B, S, H, P, N) and the
    kernel's chunk (``ref.ssd_chunk_length``): each pass's grid, pass 3's
    threads, the dynamic shared memory of passes 1 and 3, and the scratch
    bytes the launcher allocates.  Mirrors ``ssd_scan_wgmma_layout``."""
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must divide S = {s} and be at most "
                         f"{MAX_CHUNK}")
    nc = s // chunk
    states = b * h * nc * n * p
    return {"chunks": nc, "pass1_grid": (nc, h, b),
            "pass1_smem_bytes": _PASS1_SMEM,
            "pass2_grid": (-(-(n * p) // _PASS2_THREADS), b * h),
            "pass3_grid": (nc, h, b), "pass3_threads": _PASS3_THREADS,
            "pass3_smem_bytes": _PASS3_SMEM,
            "scratch_bytes": 4 * states + 2 * states + 4 * b * h * s
            + 4 * b * h * nc}


def ffma_layout(b: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The FFMA route's three launches at (B, S, H, P, N) and the kernel's
    chunk: each pass's grid, passes 1 and 3's threads and dynamic shared
    memory, the 64-row tiles pass 3 walks in a chunk, and the scratch
    bytes the launcher allocates (f32 chunk states and f32 entering
    states).  Mirrors ``ssd_scan_f32_layout``."""
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk} must divide S = {s} and be at most "
                         f"{MAX_CHUNK}")
    nc = s // chunk
    states = b * h * nc * n * p
    return {"chunks": nc, "pass1_grid": (nc, h, b),
            "pass1_threads": _FFMA_PASS1_THREADS,
            "pass1_smem_bytes": _FFMA_PASS1_SMEM,
            "pass2_grid": (-(-(n * p) // _PASS2_THREADS), b * h),
            "pass3_grid": (nc, h, b), "pass3_threads": _FFMA_PASS3_THREADS,
            "pass3_smem_bytes": _FFMA_PASS3_SMEM,
            "pass3_row_tiles": -(-chunk // 64),
            "scratch_bytes": 8 * states + 4 * b * h * s + 4 * b * h * nc}


def check_operands(x, dt, a, b_mat, c_mat,
                   device: torch.device) -> tuple[int, int, int, int, int,
                                                  int]:
    """Raise on what the kernels do not take (the chunk aside); return
    (B, S, H, P, G, N)."""
    if x.dim() != 4 or b_mat.dim() != 4:
        raise ValueError(f"expected x (B, S, H, P) and b_mat (B, S, G, N), "
                         f"got {tuple(x.shape)} and {tuple(b_mat.shape)}")
    if x.dtype not in _ROUTES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(_ROUTES)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    check_operand("x", x, (bsz, s, h, p), (x.dtype,), device)
    check_operand("dt", dt, (bsz, s, h), (torch.float32,), device)
    check_operand("a", a, (h,), (torch.float32,), device)
    check_operand("b_mat", b_mat, (bsz, s, g, n), (x.dtype,), device)
    check_operand("c_mat", c_mat, (bsz, s, g, n), (x.dtype,), device)
    if g < 1 or h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    return bsz, s, h, p, g, n


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """The SSD scan on the card.

    x:     (B, S, H, P) bf16 (tensor cores) or f32 (FFMA)
    dt:    (B, S, H) f32
    a:     (H,) f32, negative
    b_mat: (B, S, G, N), c_mat: (B, S, G, N), x's dtype; G divides H
    chunk: as the TPU kernel takes it: min(chunk, S), halved until it
           divides S (``ref.ssd_chunk_length``)
    returns y (B, S, H, P) in x's dtype
    """
    global ssd_launches, ssd_tc_launches
    device = build.cuda_device("ssd_scan", x)
    bsz, s, h, p, g, n = check_operands(x, dt, a, b_mat, c_mat, device)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    length = ssd_chunk_length(s, chunk)
    if length > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, head_dim "
                         f"<= {MAX_HEAD_DIM} and d_state <= {MAX_STATE}; got "
                         f"{length}, {p} and {n}")
    lib, symbol, errors = _ROUTES[x.dtype]
    nc = s // length
    f32 = dict(dtype=torch.float32, device=device)
    # scratch: chunk states (f32), entering states (x's dtype), cum, decay
    tensors = [x, dt, a, b_mat, c_mat, y,
               torch.empty((bsz, h, nc, n, p), **f32),
               torch.empty((bsz, h, nc, n, p), dtype=x.dtype, device=device),
               torch.empty((bsz, h, s), **f32),
               torch.empty((bsz, h, nc), **f32)]
    build.launch("ssd_scan", lib, symbol, tensors,
                 [bsz, s, h, p, g, n, length], device, errors)
    ssd_launches += 1
    ssd_heads[h] = ssd_heads.get(h, 0) + 1
    if lib == TC_LIB:
        ssd_tc_launches += 1
    return y
