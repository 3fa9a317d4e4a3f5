"""Plain PyTorch versions of the ELL aggregation kernel (the allclose targets).

Counterparts of ``community_spmm_ell_einsum`` and ``community_spmm_ell_ref``
in src/repro/kernels/ref.py.  The CPU dispatch in ``kernels.ops`` runs
``community_spmm_ell_einsum``; ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch


def community_spmm_ell_einsum(ell_blocks: torch.Tensor,
                              ell_indices: torch.Tensor,
                              ell_mask: torch.Tensor, z_all: torch.Tensor,
                              row_counts: torch.Tensor | None = None,
                              nbr_counts: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Gather-einsum form of the ELL aggregation.

    ``row_counts`` (k,) / ``nbr_counts`` (k, max_deg) reproduce the
    kernel's pad-row guards: output rows ≥ row_counts[m] and gathered Z
    rows ≥ nbr_counts[m, d] contribute nothing.  Blocks may be bf16;
    accumulation is f32.
    """
    z_g = z_all[ell_indices.long()] * ell_mask[..., None, None].to(z_all.dtype)
    if nbr_counts is not None:
        lane = torch.arange(z_all.shape[-2], device=z_all.device)
        z_g = z_g * (lane[None, None, :, None]
                     < nbr_counts[..., None, None]).to(z_g.dtype)
    out = torch.einsum("mdip,mdpc->mic", ell_blocks.float(),
                       z_g.float()).to(z_all.dtype)
    if row_counts is not None:
        lane = torch.arange(out.shape[-2], device=out.device)
        out = out * (lane[None, :, None]
                     < row_counts[:, None, None]).to(out.dtype)
    return out


def community_spmm_ell_ref(ell_blocks: torch.Tensor, ell_indices: torch.Tensor,
                           ell_mask: torch.Tensor, z_all: torch.Tensor,
                           row_counts: torch.Tensor | None = None,
                           nbr_counts: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Loop oracle for the block-compressed (ELL) aggregation."""
    m, max_deg = ell_indices.shape
    n_pad = ell_blocks.shape[2]
    out = torch.zeros((m, n_pad, z_all.shape[-1]), dtype=z_all.dtype,
                      device=z_all.device)
    lane = torch.arange(n_pad, device=z_all.device)
    for row in range(m):
        acc = torch.zeros((n_pad, z_all.shape[-1]), dtype=torch.float32,
                          device=z_all.device)
        for d in range(max_deg):
            z = z_all[int(ell_indices[row, d])].float()
            if nbr_counts is not None:
                z = z * (lane[:, None] < nbr_counts[row, d])
            acc += ell_mask[row, d] * (ell_blocks[row, d].float() @ z)
        if row_counts is not None:
            acc = acc * (lane[:, None] < row_counts[row])
        out[row] = acc.to(z_all.dtype)
    return out
