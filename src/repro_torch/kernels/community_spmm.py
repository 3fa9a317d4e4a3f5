"""Launcher for the hand-written Hopper ELL aggregation kernel.

``csrc/community_spmm_ell.cu`` replaces the Pallas TPU kernel
``community_spmm_ell`` (src/repro/kernels/community_spmm.py).  This module
checks the operands, allocates the output, and launches the kernel on the
current CUDA stream through the library ``build.load`` compiles at first
use.  Outputs never need a gradient on the trainer's path (they reach every
objective as constants), so there is no ``autograd.Function``: the launcher
runs on detached inputs.

``launches`` counts kernel launches, one per call that reaches the kernel;
callers that want the count of one phase reset it to 0 before the phase.

The launcher reads no values from the device: the indices of live slots
must lie in ``[0, M)``, which ``check_indices`` verifies once where the
layout is built (``core.parallel.community_data``), not on every launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LIB = "community_spmm_ell"
launches = 0

_SYMBOLS = {torch.float32: "community_spmm_ell_f32",
            torch.bfloat16: "community_spmm_ell_bf16"}
_INT = (torch.int32,)


def _fn(dtype: torch.dtype):
    lib = build.load(LIB)
    fn = getattr(lib, _SYMBOLS[dtype])
    if fn.argtypes is None:     # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.community_spmm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn, lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_indices(ell_indices: torch.Tensor, ell_mask: torch.Tensor,
                  m_total: int) -> None:
    """Raise IndexError unless every live slot indexes one of ``m_total``
    communities; a masked slot's index may hold any value."""
    live = ell_indices[ell_mask != 0]
    if live.numel() and (int(live.min()) < 0 or int(live.max()) >= m_total):
        raise IndexError(f"a live ELL slot indexes outside z_all's "
                         f"{m_total} communities")


def community_spmm_ell(ell_blocks: torch.Tensor, ell_indices: torch.Tensor,
                       ell_mask: torch.Tensor, z_all: torch.Tensor,
                       row_counts: torch.Tensor,
                       nbr_counts: torch.Tensor) -> torch.Tensor:
    """Σ_d [mask[m,d] ≠ 0] · blocks[m,d] @ z_all[idx[m,d]] on the card.

    ell_blocks:  (k, D, n_pad, n_pad) f32 or bf16
    ell_indices: (k, D) int32 — community ids into z_all (live slots only
                 are read; they must lie in [0, M), see check_indices)
    ell_mask:    (k, D) int32 — nonzero = live slot
    z_all:       (M, n_pad, C) f32
    row_counts:  (k,) int32 — output rows at or past it are zero
    nbr_counts:  (k, D) int32 — rows of each neighbour that contribute
    returns      (k, n_pad, C) f32
    """
    global launches
    device = z_all.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if ell_blocks.dim() != 4 or z_all.dim() != 3:
        raise ValueError(f"expected blocks (k, D, n, n) and z_all (M, n, C), "
                         f"got {tuple(ell_blocks.shape)} and "
                         f"{tuple(z_all.shape)}")
    k, d, n_pad, _ = ell_blocks.shape
    m_total, _, c = z_all.shape
    _check("ell_blocks", ell_blocks, (k, d, n_pad, n_pad),
           tuple(_SYMBOLS), device)
    _check("z_all", z_all, (m_total, n_pad, c), (torch.float32,), device)
    _check("ell_indices", ell_indices, (k, d), _INT, device)
    _check("ell_mask", ell_mask, (k, d), _INT, device)
    _check("row_counts", row_counts, (k,), _INT, device)
    _check("nbr_counts", nbr_counts, (k, d), _INT, device)
    out = torch.empty((k, n_pad, c), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    fn, lib = _fn(ell_blocks.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(ell_blocks.data_ptr(), ell_indices.data_ptr(),
                  ell_mask.data_ptr(), row_counts.data_ptr(),
                  nbr_counts.data_ptr(), z_all.data_ptr(), out.data_ptr(),
                  k, d, n_pad, c, stream)
    if code != 0:
        msg = lib.community_spmm_error_string(code).decode()
        raise RuntimeError(f"community_spmm_ell launch failed: {msg} "
                           f"(cudaError {code})")
    launches += 1
    return out
