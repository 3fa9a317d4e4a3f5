"""Plain PyTorch versions of the kernels (the allclose targets).

Counterparts of ``community_spmm_ref``, ``community_spmm_ell_einsum``,
``community_spmm_ell_ref``, ``community_spmm_ell_packed_einsum``,
``community_spmm_ell_fused_einsum``, ``flash_attention_ref`` and
``ssd_scan_ref`` in src/repro/kernels/ref.py.  The CPU dispatch in
``kernels.ops`` runs the einsum forms; ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.  ``ssd_scan_three_pass`` is
the tensor-core SSD kernel's decomposition in plain PyTorch, for the tests
and ``chip_smoke.py`` only.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30      # the flash kernels' mask value


def community_spmm_ref(a_row: torch.Tensor, z_all: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Σ_r mask_r · Ã_{m,r} Z_r — dense einsum form of the block-row
    aggregation.

    a_row (M, n, n) with mask (M,) gives (n, C), as the reference; a_row
    (k, M, n, n) with a per-lane (k, M) or shared (M,) mask gives (k, n, C),
    what the reference's vmap over lanes gives.  A masked block is
    multiplied by 0, so it contributes nothing when its values are finite.
    Each lane is its own product over (M · n) (Z broadcast over the lanes,
    not the lanes folded into one GEMM), as the ELL gather-einsum runs.
    """
    masked = a_row * mask[..., None, None].to(a_row.dtype)
    z = z_all.expand(*masked.shape[:-3], *z_all.shape)
    return torch.einsum("...rip,...rpc->...ic", masked, z)


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


def community_spmm_ell_packed_einsum(ell_blocks: torch.Tensor,
                                     ell_offsets: torch.Tensor,
                                     ell_mask: torch.Tensor,
                                     z_plane: torch.Tensor,
                                     row_counts: torch.Tensor,
                                     nbr_counts: torch.Tensor
                                     ) -> torch.Tensor:
    """Gather-einsum form of the packed-plane ELL aggregation.

    ``z_plane`` is the packed (plane_rows, C) plane; neighbour d of lane m
    starts at row ``ell_offsets[m, d]`` and contributes ``nbr_counts[m, d]``
    rows.  Rows past a neighbour's count, masked slots and rows outside the
    plane gather 0 (the reference's take with ``mode="fill"``), so the
    blocked (k, D, n_pad, C) view is the strided oracle's masked gather.
    """
    k, max_deg = ell_offsets.shape
    n_pad = ell_blocks.shape[2]
    plane_rows, c = z_plane.shape
    lane = torch.arange(n_pad, device=z_plane.device)
    rows = ell_offsets.long()[..., None] + lane[None, None, :]   # (k, D, n)
    valid = ((lane[None, None, :] < nbr_counts[..., None])
             & (ell_mask[..., None] != 0) & (rows >= 0) & (rows < plane_rows))
    rows = torch.where(valid, rows, plane_rows)                # OOB -> fill
    filled = torch.cat([z_plane, z_plane.new_zeros((1, c))])
    z_g = filled[rows.reshape(-1)].reshape(k, max_deg, n_pad, c)
    out = torch.einsum("mdip,mdpc->mic", ell_blocks.float(),
                       z_g.float()).to(z_plane.dtype)
    return out * (lane[None, :, None]
                  < row_counts[:, None, None]).to(out.dtype)


def community_spmm_ell_fused_einsum(ell_blocks: torch.Tensor,
                                    ell_offsets: torch.Tensor,
                                    ell_mask: torch.Tensor,
                                    z_plane: torch.Tensor, w: torch.Tensor,
                                    row_counts: torch.Tensor,
                                    nbr_counts: torch.Tensor
                                    ) -> torch.Tensor:
    """Plain version of the fused aggregation→GEMM: (A·Z)·W = A·(Z·W).

    Reassociated as the reference's oracle is: W is applied to the packed
    plane first, then the packed aggregation runs on the pre-multiplied
    plane, so no (k, n_pad, C_in) aggregate is formed.  Against the CUDA
    kernel, which sums (A·Z) first, parity is a tolerance, not bitwise.
    """
    zw = (z_plane.float() @ w.float()).to(z_plane.dtype)
    return community_spmm_ell_packed_einsum(ell_blocks, ell_offsets,
                                            ell_mask, zw, row_counts,
                                            nbr_counts)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Exact softmax attention with GQA and causal / window masks, in f32;
    q (B, S_q, Hq, hd), k and v (B, S_k, Hkv, hd) -> (B, S_q, Hq, hd) in
    q's dtype, query row r at key position ``q_offset`` + r.  Masked scores
    take -2^30, as in the kernels."""
    b, s, hq, hd = q.shape
    s_k, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, hd).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(q_offset, q_offset + s, device=q.device)
    kpos = torch.arange(s_k, device=q.device)
    mask = torch.ones((s, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= pos[:, None] - kpos[None, :] < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def ssd_chunk_length(seq: int, chunk: int) -> int:
    """The chunk the SSD kernels take: ``min(chunk, seq)``, halved until it
    divides ``seq`` (src/repro/kernels/ssd_scan.py:74-76).  Any divisor may
    come out: S = 100 gives 100, S = 1000 gives 8."""
    chunk = min(chunk, seq)
    while seq % chunk:
        chunk //= 2
    return chunk


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                 chunk: int = 256) -> torch.Tensor:
    """Chunked SSD scan in f32 at the kernel's chunk length; y in x's
    dtype, as the kernel returns it.

    Unlike the reference's oracle, which asserts that ``chunk`` divides S
    (src/repro/models/ssm.py:82), this halves the chunk as the kernel does,
    so every S the kernel takes has a plain version."""
    from repro_torch.models.ssm import ssd_chunked
    f32 = torch.float32
    y, _ = ssd_chunked(x.to(f32), dt.to(f32), a.to(f32), b_mat.to(f32),
                       c_mat.to(f32), ssd_chunk_length(x.shape[1], chunk))
    return y.to(x.dtype)


def ssd_scan_three_pass(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                        chunk: int = 256,
                        round_bf16: bool = False) -> torch.Tensor:
    """The SSD scan as the tensor-core kernel (csrc/ssd_scan_wgmma.cu)
    splits it, in f32: chunk states S_c = Σ_u (B_u w_u) x_uᵀ with
    w_u = exp(cum_L − cum_u)·dt_u; the state entering each chunk, in_0 = 0,
    in_{c+1} = exp(cum_L)·in_c + S_c; and the output
    y_t = exp(cum_t)·C_t·in_c
          + Σ_{u≤t} (C_t·B_u)·exp(cum_t − cum_u)·dt_u·x_u.

    ``round_bf16`` rounds to bf16 the three operands the kernel rounds
    before a tensor-core product: B·w, the entering state and the decayed
    scores.  y in x's dtype."""
    f32 = torch.float32
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    length = ssd_chunk_length(s, chunk)
    nc = s // length

    def rnd(t):
        return t.to(torch.bfloat16).to(f32) if round_bf16 else t

    xc = x.to(f32).reshape(bsz, nc, length, h, p)
    dtc = dt.to(f32).reshape(bsz, nc, length, h)
    bc, cc = (m.to(f32).reshape(bsz, nc, length, g, n)
              .repeat_interleave(h // g, dim=3) for m in (b_mat, c_mat))
    cum = torch.cumsum(dtc * a.to(f32), dim=2)             # (B, NC, L, H)

    # 1. chunk states
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    states = torch.einsum("bcuhn,bcuhp->bchnp", rnd(bc * w[..., None]), xc)
    # 2. the state entering each chunk, carried in f32
    decay = torch.exp(cum[:, :, -1])                      # (B, NC, H)
    entering = [torch.zeros_like(states[:, 0])]
    for c in range(nc - 1):
        entering.append(decay[:, c, :, None, None] * entering[-1]
                        + states[:, c])
    entering = rnd(torch.stack(entering, dim=1))          # (B, NC, H, N, P)
    # 3. the output: the carried-in state's term, then the chunk's own
    y = torch.exp(cum)[..., None] * torch.einsum("bcthn,bchnp->bcthp", cc,
                                                 entering)
    li = torch.arange(length, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, NC, T, U, H)
    scores = torch.einsum("bcthn,bcuhn->bctuh", cc, bc)
    scores = torch.where(causal, scores * torch.exp(torch.where(
        causal, seg, 0.0)) * dtc[:, :, None], 0.0)
    y = y + torch.einsum("bctuh,bcuhp->bcthp", rnd(scores), xc)
    return y.reshape(bsz, s, h, p).to(x.dtype)
