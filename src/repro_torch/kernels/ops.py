"""Kernel wrappers with dispatch by the tensors' device.

A CUDA tensor runs the hand-written CUDA kernel; a CPU tensor runs the
plain PyTorch version — as src/repro/kernels/ops.py runs the Pallas kernel
on a TPU and its jnp oracle elsewhere.  A kernel that fails to build or
launch raises: nothing falls back to the plain version.  Under an op-trace
recorder (``analysis.trace``) a plain aggregation is recorded as the
kernel launch it stands in for, with the launch spec the kernel would take,
so that a trace on the CPU carries the same kernel events as one on the
card.  The FISTA prox's plain version (``fista_lanes``) is the trainer's
own host loop, ``core.parallel.fista_lanes``.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import trace
from repro_torch.kernels import community_spmm as launchers
from repro_torch.kernels import fista as fista_launcher
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_launcher


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _mask(t: torch.Tensor) -> torch.Tensor:
    """An int32 mask reaches the kernel as it is (tested ``!= 0``)."""
    if t.dtype != torch.int32:
        t = (t != 0).to(torch.int32)
    return t.contiguous()


def _align(t: torch.Tensor, row: int) -> int:
    return launchers.copy_align(t.data_ptr(), row * t.element_size())


def _plain(spec, out: torch.Tensor, **tensors) -> torch.Tensor:
    """``out`` of a plain version, recorded as the kernel event of ``spec``
    when a trace is being recorded."""
    if trace.RECORDER is not None:
        trace.RECORDER.kernel(spec(), dict(tensors, out=out), "plain")
    return out


def community_spmm(a_row: torch.Tensor, z_all: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_r Ã_{m,r} Z_r with block-sparse skipping.

    a_row:  (M, n_pad, n_pad) for one block row, or (k, M, n_pad, n_pad)
            for k lanes; f32
    z_all:  (M, n_pad, C) f32
    mask:   None (every block live), a shared (M,) row, or per-lane (k, M)
            — nonzero = live block
    returns (n_pad, C) for one row, (k, n_pad, C) for lanes

    The CUDA kernel never reads a masked block; the plain version on the
    CPU multiplies it by 0.
    """
    if mask is None:
        mask = torch.ones((a_row.shape[-3],), dtype=torch.int32,
                          device=a_row.device)
    if z_all.device.type == "cpu":
        m_total, n_pad, c = z_all.shape
        return _plain(
            lambda: launchers.spmm_spec(
                a_row.shape[0] if a_row.dim() == 4 else 1, m_total, n_pad,
                c, z_align=_align(z_all, c), a_align=_align(a_row, n_pad)),
            ref.community_spmm_ref(a_row, z_all, mask), a_row=a_row,
            z_all=z_all, mask=mask)
    lanes = a_row if a_row.dim() == 4 else a_row[None]
    k, m_total = lanes.shape[:2]
    out = launchers.community_spmm(
        lanes.detach().contiguous(), z_all.detach().contiguous(),
        _mask(mask).expand(k, m_total).contiguous())
    return out if a_row.dim() == 4 else out[0]


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
    already int32 and contiguous reach the kernel without a copy.
    """
    k, max_deg, n_pad, _ = ell_blocks.shape
    if z_all.device.type == "cpu":
        m_total, _, c = z_all.shape
        return _plain(
            lambda: launchers.ell_spec(
                k, max_deg, n_pad, c, m_total,
                block_bytes=ell_blocks.element_size(),
                z_align=_align(z_all, c), a_align=_align(ell_blocks, n_pad)),
            ref.community_spmm_ell_einsum(ell_blocks, ell_indices, ell_mask,
                                          z_all, row_counts, nbr_counts),
            ell_blocks=ell_blocks, ell_indices=ell_indices,
            ell_mask=ell_mask, row_counts=row_counts, nbr_counts=nbr_counts,
            z_all=z_all)
    i32 = dict(dtype=torch.int32, device=z_all.device)
    if row_counts is None:
        row_counts = torch.full((k,), n_pad, **i32)
    if nbr_counts is None:
        nbr_counts = torch.full((k, max_deg), n_pad, **i32)
    return launchers.community_spmm_ell(
        ell_blocks.detach().contiguous(), _i32(ell_indices), _mask(ell_mask),
        z_all.detach().contiguous(), _i32(row_counts), _i32(nbr_counts))


def community_spmm_ell_packed(ell_blocks: torch.Tensor,
                              ell_offsets: torch.Tensor,
                              ell_mask: torch.Tensor, z_plane: torch.Tensor,
                              row_counts: torch.Tensor,
                              nbr_counts: torch.Tensor) -> torch.Tensor:
    """Packed-plane ELL aggregation: neighbour d of lane m is rows
    ``[ell_offsets[m, d], ell_offsets[m, d] + nbr_counts[m, d])`` of the
    packed ``(plane_rows, C)`` plane, instead of a fixed ``n_pad`` stride.

    Same dispatch contract as ``community_spmm_ell``; returns the blocked
    (k, n_pad, C) aggregate with rows past ``row_counts`` zero.
    """
    if z_plane.device.type == "cpu":
        k, d, n_pad, _ = ell_blocks.shape
        rows, c = z_plane.shape
        return _plain(
            lambda: launchers.ell_packed_spec(
                k, d, n_pad, c, rows, block_bytes=ell_blocks.element_size(),
                z_align=_align(z_plane, c),
                a_align=_align(ell_blocks, n_pad)),
            ref.community_spmm_ell_packed_einsum(
                ell_blocks, ell_offsets, ell_mask, z_plane, row_counts,
                nbr_counts),
            ell_blocks=ell_blocks, ell_offsets=ell_offsets,
            ell_mask=ell_mask, row_counts=row_counts, nbr_counts=nbr_counts,
            z_plane=z_plane)
    return launchers.community_spmm_ell_packed(
        ell_blocks.detach().contiguous(), _i32(ell_offsets), _mask(ell_mask),
        z_plane.detach().contiguous(), _i32(row_counts), _i32(nbr_counts))


def community_spmm_ell_fused(ell_blocks: torch.Tensor,
                             ell_offsets: torch.Tensor,
                             ell_mask: torch.Tensor, z_plane: torch.Tensor,
                             w: torch.Tensor, row_counts: torch.Tensor,
                             nbr_counts: torch.Tensor) -> torch.Tensor:
    """Fused packed-plane aggregation → GEMM: ``(packed aggregate) @ w``.

    The CUDA kernel keeps the aggregate in shared memory and sums it
    exactly as ``community_spmm_ell_packed`` does; the plain version on the
    CPU is the reassociated ``A·(Z·W)`` of the reference's oracle, so
    parity with the unfused two-call pipeline is a tolerance, not bitwise.
    Returns (k, n_pad, C_out) with rows past ``row_counts`` zero.
    """
    if z_plane.device.type == "cpu":
        k, d, n_pad, _ = ell_blocks.shape
        rows, c_in = z_plane.shape
        return _plain(
            lambda: launchers.ell_fused_spec(
                k, d, n_pad, c_in, w.shape[1], rows,
                block_bytes=ell_blocks.element_size()),
            ref.community_spmm_ell_fused_einsum(
                ell_blocks, ell_offsets, ell_mask, z_plane, w, row_counts,
                nbr_counts),
            ell_blocks=ell_blocks, ell_offsets=ell_offsets,
            ell_mask=ell_mask, row_counts=row_counts, nbr_counts=nbr_counts,
            z_plane=z_plane, w=w)
    return launchers.community_spmm_ell_fused(
        ell_blocks.detach().contiguous(), _i32(ell_offsets), _mask(ell_mask),
        z_plane.detach().contiguous(), w.detach().float().contiguous(),
        _i32(row_counts), _i32(nbr_counts))


def community_halo_spmm(ell_blocks: torch.Tensor, ell_offsets: torch.Tensor,
                        ell_mask: torch.Tensor, self_mask: torch.Tensor,
                        z_plane: torch.Tensor, row_counts: torch.Tensor,
                        nbr_counts: torch.Tensor) -> torch.Tensor:
    """Cross-community (halo) half of the packed ELL aggregation:
    Σ_{r∈N_m\\{m}} Ã_{m,r} Z_r.  The self slot (``self_mask``, from
    ``messages.self_slot_mask``) is removed from both the slot mask and the
    per-neighbour row counts, so the diagonal block never enters the sum.
    ``halo + self block`` reassembles the full aggregate up to float
    reassociation (the split sums the slots in two groups)."""
    cross_mask = ell_mask * (1.0 - self_mask)
    cross_counts = (nbr_counts * (cross_mask > 0)).to(nbr_counts.dtype)
    return community_spmm_ell_packed(ell_blocks, ell_offsets, cross_mask,
                                     z_plane, row_counts, cross_counts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, causal / sliding window / GQA.

    q: (B, S_q, Hq, hd); k, v: (B, S_k, Hkv, hd) -> (B, S_q, Hq, hd) in q's
    dtype; query row r sits at key position ``q_offset`` + r (S_q = S_k and
    offset 0: the whole sequence).
    """
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    return flash_launcher.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, q_offset=q_offset)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *,
             chunk: int = 256) -> tuple[torch.Tensor, None]:
    """Mamba-2 SSD chunked scan; returns ``(y, None)`` as the reference.

    x: (B, S, H, P); dt: (B, S, H); a: (H,); b_mat, c_mat: (B, S, G, N).
    y is (B, S, H, P) in x's dtype; the chunk is ``min(chunk, S)`` halved
    until it divides S, on the CPU as on the card.
    """
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a, b_mat, c_mat, chunk=chunk), None
    f32 = torch.float32
    return ssd_launcher.ssd_scan(
        x.contiguous(), dt.to(f32).contiguous(), a.to(f32).contiguous(),
        b_mat.contiguous(), c_mat.contiguous(), chunk), None



def fista_lanes(admm, b: torch.Tensor, u: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor,
                z_init: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Eq. (7) per community lane: Z_L (k, n, C).

    ``admm`` gives ρ, the backtracking growth, tolerance and cap, and the
    FISTA iterations; b, u, z_init (k, n, C) f32, labels (k, n), mask (k, n),
    denom a 0-dim f32.  On the card one kernel launch on the current stream
    that reads nothing back (span-log counter ``fista.kernel``); on the CPU
    the plain host loop (``fista.plain``)."""
    if z_init.device.type == "cpu":
        from repro_torch.core import parallel   # the plain version's home
        trace.count("fista.plain")
        k, n, c = z_init.shape
        return _plain(
            lambda: fista_launcher.spec(k, n, c, admm.fista_iters),
            parallel.fista_lanes(admm, b, u, labels, mask, z_init, denom),
            b=b, u=u, labels=labels, mask=mask, z_init=z_init, denom=denom)
    return _fista_kernel(admm, b, u, labels, mask, z_init, denom)


def _fista_kernel(admm, b, u, labels, mask, z_init, denom) -> torch.Tensor:
    """``fista_lanes``' kernel route."""
    trace.count("fista.kernel")
    z, _, _ = fista_launcher.fista_lanes(
        b.detach().contiguous(), u.detach().contiguous(), _i32(labels),
        mask.detach().float().contiguous(), z_init.detach().contiguous(),
        denom.detach(), rho=admm.rho, growth=admm.backtrack_growth,
        rtol=admm.backtrack_rtol, max_backtracks=admm.max_backtracks,
        iters=admm.fista_iters)
    return z
