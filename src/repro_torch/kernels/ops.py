"""Kernel wrappers with dispatch by the tensors' device.

A CUDA tensor runs the hand-written CUDA kernel; a CPU tensor runs the
plain PyTorch version — as src/repro/kernels/ops.py runs the Pallas kernel
on a TPU and its jnp oracle elsewhere.  A kernel that fails to build or
launch raises: nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import community_spmm, ref


def community_spmm_ell(ell_blocks: torch.Tensor, ell_indices: torch.Tensor,
                       ell_mask: torch.Tensor, z_all: torch.Tensor,
                       row_counts: torch.Tensor | None = None,
                       nbr_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Block-compressed aggregation Σ_d [mask ≠ 0] Ã[m,d] Z[idx[m,d]].

    ell_blocks:  (k, max_deg, n_pad, n_pad) f32 or bf16
    ell_indices: (k, max_deg) int — community ids into z_all
    ell_mask:    (k, max_deg) — nonzero = real block, 0 = padding slot
    z_all:       (M, n_pad, C) f32
    row_counts:  optional (k,) — output rows at or past it are zero
    nbr_counts:  optional (k, max_deg) — rows each neighbour contributes
    returns      (k, n_pad, C)

    Without counts every row is live (the global-pad layout).  Operands
    already int32 and contiguous (an int32 mask is tested ``!= 0`` by the
    kernel) reach it without a copy.
    """
    if z_all.device.type == "cpu":
        return ref.community_spmm_ell_einsum(ell_blocks, ell_indices,
                                             ell_mask, z_all, row_counts,
                                             nbr_counts)
    k, max_deg, n_pad, _ = ell_blocks.shape
    i32 = dict(dtype=torch.int32, device=z_all.device)
    if row_counts is None:
        row_counts = torch.full((k,), n_pad, **i32)
    if nbr_counts is None:
        nbr_counts = torch.full((k, max_deg), n_pad, **i32)
    if ell_mask.dtype != torch.int32:
        ell_mask = (ell_mask != 0).to(torch.int32)
    return community_spmm.community_spmm_ell(
        ell_blocks.detach().contiguous(),
        ell_indices.to(torch.int32).contiguous(), ell_mask.contiguous(),
        z_all.detach().contiguous(), row_counts.to(torch.int32).contiguous(),
        nbr_counts.to(torch.int32).contiguous())
