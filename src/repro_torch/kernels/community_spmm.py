"""Launchers for the hand-written Hopper community aggregation kernels.

``csrc/community_spmm_ell.cu`` replaces the Pallas TPU kernels
``community_spmm_ell``, ``community_spmm_ell_packed`` and the dense
``community_spmm`` (one kernel in three addressings; the dense one reads
no slot table), and ``csrc/community_spmm_ell_fused.cu`` replaces
``community_spmm_ell_fused`` (src/repro/kernels/community_spmm.py).  This
module checks the operands, allocates the output, and launches a kernel on
the current CUDA stream through the library ``build.load`` compiles at
first use.  No output needs
a gradient (the trainer's reach every objective as constants; serving is
inference), so there is no ``autograd.Function``: the launchers run on
detached inputs.

Each kernel has its own launch count, one per call that reaches it:
``launches`` (ELL), ``packed_launches``, ``fused_launches`` and
``dense_launches``.  Callers
that want the count of one phase reset it to 0 before the phase.

``fused_cluster``, ``fused_grid`` and ``fused_smem_bytes`` mirror the
fused kernel's cluster launch, so that the width limit is refused here
(the card tests hold them against ``community_spmm_ell_fused_layout``).
``ell_layout`` mirrors the tile configuration the ELL / packed / dense
kernel picks for a launch (``community_spmm_ell_layout``), and
``operand_layout`` reads it off a launch's operands.

The launchers read no values from the device: the indices of live slots
must lie in ``[0, M)`` and the plane rows a live packed slot reads must lie
inside the plane, which ``check_indices`` and ``check_plane_offsets`` verify
once where the tables are built (``core.parallel.community_data``,
``serve.engine.CommunityServer``), not on every launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand as _check
from repro_torch.kernels.build import cuda_device as _cuda_device

LIB = "community_spmm_ell"          # the ELL, packed and dense launches
FUSED_LIB = "community_spmm_ell_fused"
launches = 0
packed_launches = 0
fused_launches = 0
dense_launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT = (torch.int32,)
# the fused kernel spreads a 32-row tile's (32, C_in) f32 aggregate over a
# cluster of up to 8 blocks in 128-column chunks; each block holds its
# chunks (16 KB each) and 21,504 bytes of staging tiles in shared memory
_FUSED_ROWS, _FUSED_CHUNK, _FUSED_MAX_CLUSTER = 32, 128, 8
_FUSED_STATIC = 4 * 32 * ((32 + 4) + (128 + 4))
_SMEM_LIMIT = 232448
# the ELL / packed kernel's tile configurations, (BM, BN, TM, TN, stages):
# 128 x 128 output tiles with 8 x 8 per thread where that grid fills an
# H100 SXM's 132 SMs twice over; else 64 x 64 with 8 x 4, or 64 x 32 with
# 4 x 4 where its busiest SM carries less (a half tile costs ~1.2x per
# FLOP: 3 half-tile slots against 5 small-tile slots); 64 x 16 with 4 x 1
# where C <= 32.  A ring of 32-row stages, each an A tile (a row of 32
# values and 16 bytes of pad per output row) and a (32, BN) f32 Z tile.
ELL_TILES = {"large": (128, 128, 8, 8, 3), "small": (64, 64, 8, 4, 4),
             "half": (64, 32, 4, 4, 4), "narrow": (64, 16, 4, 1, 4)}
_ELL_BK, _ELL_A_PAD, _ELL_SMS = 32, 16, 132
_ELL_LARGE_MIN_GRID = 2 * _ELL_SMS
_ELL_HALF_COST, _ELL_SMALL_COST = 3, 5
_ELL_NARROW_MAX_C = 32


def _launch(kernel: str, lib_name: str, symbol: str, ptrs: list,
            ints: list, device: torch.device) -> None:
    build.launch(kernel, lib_name, symbol, ptrs, ints, device,
                 "community_spmm_error_string")


def check_indices(ell_indices: torch.Tensor, ell_mask: torch.Tensor,
                  m_total: int) -> None:
    """Raise IndexError unless every live slot indexes one of ``m_total``
    communities; a masked slot's index may hold any value."""
    live = ell_indices[ell_mask != 0]
    if live.numel() and (int(live.min()) < 0 or int(live.max()) >= m_total):
        raise IndexError(f"a live ELL slot indexes outside z_all's "
                         f"{m_total} communities")


def check_plane_offsets(offsets, mask, nbr_counts, plane_rows: int) -> None:
    """Raise IndexError unless every live slot's rows ``[off, off +
    nbr_count)`` lie inside a ``plane_rows``-row plane; a masked slot's
    offset and count may hold any value."""
    offsets, mask, nbr_counts = (torch.as_tensor(x) for x in
                                 (offsets, mask, nbr_counts))
    live = mask != 0
    start = offsets[live].long()
    end = start + nbr_counts[live].long()
    if start.numel() and (int(start.min()) < 0
                          or int(end.max()) > plane_rows):
        raise IndexError(f"a live ELL slot reads outside the packed plane's "
                         f"{plane_rows} rows")


def _check_ell_operands(device, ell_blocks, table_name, table, ell_mask,
                        row_counts, nbr_counts) -> tuple[int, int, int]:
    if ell_blocks.dim() != 4:
        raise ValueError(f"expected blocks (k, D, n, n), got "
                         f"{tuple(ell_blocks.shape)}")
    k, d, n_pad, _ = ell_blocks.shape
    _check("ell_blocks", ell_blocks, (k, d, n_pad, n_pad), tuple(_DTYPES),
           device)
    _check(table_name, table, (k, d), _INT, device)
    _check("ell_mask", ell_mask, (k, d), _INT, device)
    _check("row_counts", row_counts, (k,), _INT, device)
    _check("nbr_counts", nbr_counts, (k, d), _INT, device)
    return k, d, n_pad


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
    device = _cuda_device("community_spmm_ell", z_all)
    if z_all.dim() != 3:
        raise ValueError(f"expected z_all (M, n, C), got "
                         f"{tuple(z_all.shape)}")
    k, d, n_pad = _check_ell_operands(device, ell_blocks, "ell_indices",
                                      ell_indices, ell_mask, row_counts,
                                      nbr_counts)
    m_total, _, c = z_all.shape
    _check("z_all", z_all, (m_total, n_pad, c), (torch.float32,), device)
    out = torch.empty((k, n_pad, c), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("community_spmm_ell", LIB,
            f"community_spmm_ell_{_DTYPES[ell_blocks.dtype]}",
            [ell_blocks, ell_indices, ell_mask, row_counts, nbr_counts,
             z_all, out], [k, d, n_pad, c], device)
    launches += 1
    return out


def community_spmm_ell_packed(ell_blocks: torch.Tensor,
                              ell_offsets: torch.Tensor,
                              ell_mask: torch.Tensor, z_plane: torch.Tensor,
                              row_counts: torch.Tensor,
                              nbr_counts: torch.Tensor) -> torch.Tensor:
    """Σ_d [mask[m,d] ≠ 0] · blocks[m,d] @ plane[off[m,d] : off[m,d] + n]
    on the card, rows p ≥ nbr_counts[m,d] of each neighbour left out.

    ell_blocks:  (k, D, n_pad, n_pad) f32 or bf16
    ell_offsets: (k, D) int32 — plane row of each neighbour's row 0 (live
                 slots only are read; see check_plane_offsets)
    ell_mask:    (k, D) int32 — nonzero = live slot
    z_plane:     (R, C) f32 packed plane
    row_counts:  (k,) int32 — output rows at or past it are zero
    nbr_counts:  (k, D) int32 — rows of each neighbour that contribute
    returns      (k, n_pad, C) f32
    """
    global packed_launches
    device = _cuda_device("community_spmm_ell_packed", z_plane)
    if z_plane.dim() != 2:
        raise ValueError(f"expected z_plane (R, C), got "
                         f"{tuple(z_plane.shape)}")
    k, d, n_pad = _check_ell_operands(device, ell_blocks, "ell_offsets",
                                      ell_offsets, ell_mask, row_counts,
                                      nbr_counts)
    _check("z_plane", z_plane, tuple(z_plane.shape), (torch.float32,),
           device)
    c = z_plane.shape[1]
    out = torch.empty((k, n_pad, c), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("community_spmm_ell_packed", LIB,
            f"community_spmm_ell_packed_{_DTYPES[ell_blocks.dtype]}",
            [ell_blocks, ell_offsets, ell_mask, row_counts, nbr_counts,
             z_plane, out], [k, d, n_pad, c], device)
    packed_launches += 1
    return out


def copy_align(ptr: int, row_bytes: int) -> int:
    """Largest of 16, 8, 4, 2, 1 bytes dividing both a pointer and a row
    stride: the widest copy every row of the operand allows."""
    v = ptr | row_bytes
    return 16 if v % 16 == 0 else v & -v


def ell_layout(k: int, n_pad: int, c: int, block_bytes: int, z_align: int,
               a_align: int) -> dict:
    """The ELL / packed kernel's launch for k lanes, n_pad rows, C columns,
    blocks of ``block_bytes`` (4 f32, 2 bf16) and the operands' alignments
    in bytes (``copy_align``): the tile configuration, its grid, the
    dynamic shared memory of its stage ring, and the copy width of each
    operand (16 bytes where aligned; else 4, or 2 for bf16 rows of odd
    length).  Mirrors ``community_spmm_ell_layout``."""
    if block_bytes not in (2, 4):
        raise ValueError(f"block_bytes must be 4 (f32) or 2 (bf16), got "
                         f"{block_bytes}")

    def grid(tile):
        bm, bn = ELL_TILES[tile][:2]
        return -(-c // bn), -(-n_pad // bm), k

    def busiest(tile):          # tiles on the busiest SM
        return -(-math.prod(grid(tile)) // _ELL_SMS)

    if c <= _ELL_NARROW_MAX_C:
        tile = "narrow"
    elif math.prod(grid("large")) >= _ELL_LARGE_MIN_GRID:
        tile = "large"
    elif (_ELL_HALF_COST * busiest("half")
          < _ELL_SMALL_COST * busiest("small")):
        tile = "half"
    else:
        tile = "small"
    bm, bn, tm, tn, stages = ELL_TILES[tile]
    a_row = _ELL_BK * block_bytes + _ELL_A_PAD
    return {"tile": tile, "bm": bm, "bn": bn, "tm": tm, "tn": tn,
            "threads": bm // tm * (bn // tn), "stages": stages,
            "grid": grid(tile),
            "smem_bytes": stages * (bm * a_row + _ELL_BK * bn * 4),
            "a_copy": (16 if a_align >= 16 else
                       4 if block_bytes == 4 or a_align >= 4 else 2),
            "z_copy": 16 if bn >= 32 and z_align >= 16 else 4}


def operand_layout(ell_blocks: torch.Tensor, z: torch.Tensor) -> dict:
    """``ell_layout`` of a launch on these operands: blocks (k, D, n, n),
    z the strided z_all (M, n, C) or the packed plane (R, C); or the dense
    launch's a_row (k, M, n, n) and z_all (M, n, C)."""
    k, _, n_pad, _ = ell_blocks.shape
    c = z.shape[-1]
    bb = ell_blocks.element_size()
    return ell_layout(k, n_pad, c, bb, copy_align(z.data_ptr(), 4 * c),
                      copy_align(ell_blocks.data_ptr(), bb * n_pad))


def fused_cluster(c_in: int) -> tuple[int, int]:
    """(blocks per cluster, aggregate chunks per block) of the fused kernel
    at width C_in: ceil(C_in / 128) chunks (at least one) over a cluster
    of at most 8 blocks, block r owning chunks r, r + cluster, ..."""
    chunks = max(1, -(-c_in // _FUSED_CHUNK))
    cluster = min(chunks, _FUSED_MAX_CLUSTER)
    return cluster, -(-chunks // cluster)


def fused_grid(k: int, n_pad: int, c_in: int) -> tuple[int, int, int]:
    """The fused kernel's grid: (cluster blocks, 32-row tiles, lanes)."""
    return fused_cluster(c_in)[0], -(-n_pad // _FUSED_ROWS), k


def fused_smem_bytes(c_in: int) -> int:
    """Shared memory one block of the fused kernel takes at width C_in:
    its aggregate chunks and the staging tiles."""
    return (fused_cluster(c_in)[1] * _FUSED_ROWS * _FUSED_CHUNK * 4
            + _FUSED_STATIC)


def check_fused_operands(device, ell_blocks, ell_offsets, ell_mask,
                         z_plane, w, row_counts,
                         nbr_counts) -> tuple[int, int, int, int, int]:
    """Raise on what the fused kernel does not take, C_in too wide for a
    block's shared memory included; return (k, D, n_pad, C_in, C_out)."""
    if z_plane.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected z_plane (R, C_in) and w (C_in, C_out), "
                         f"got {tuple(z_plane.shape)} and {tuple(w.shape)}")
    k, d, n_pad = _check_ell_operands(device, ell_blocks, "ell_offsets",
                                      ell_offsets, ell_mask, row_counts,
                                      nbr_counts)
    _check("z_plane", z_plane, tuple(z_plane.shape), (torch.float32,),
           device)
    c_in, c_out = z_plane.shape[1], w.shape[1]
    _check("w", w, (c_in, c_out), (torch.float32,), device)
    if fused_smem_bytes(c_in) > _SMEM_LIMIT:
        raise ValueError(f"C_in = {c_in} needs {fused_smem_bytes(c_in)} "
                         f"bytes of shared memory per block; the card has "
                         f"{_SMEM_LIMIT}")
    return k, d, n_pad, c_in, c_out


def community_spmm_ell_fused(ell_blocks: torch.Tensor,
                             ell_offsets: torch.Tensor,
                             ell_mask: torch.Tensor, z_plane: torch.Tensor,
                             w: torch.Tensor, row_counts: torch.Tensor,
                             nbr_counts: torch.Tensor) -> torch.Tensor:
    """(packed aggregate) @ w on the card in one pass: the operands of
    ``community_spmm_ell_packed`` plus w (C_in, C_out) f32.  The aggregate
    stays in the shared memory of a thread-block cluster and is bitwise the
    packed kernel's output.
    Returns (k, n_pad, C_out) f32, rows at or past row_counts zero."""
    global fused_launches
    device = _cuda_device("community_spmm_ell_fused", z_plane)
    k, d, n_pad, c_in, c_out = check_fused_operands(
        device, ell_blocks, ell_offsets, ell_mask, z_plane, w, row_counts,
        nbr_counts)
    out = torch.empty((k, n_pad, c_out), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("community_spmm_ell_fused", FUSED_LIB,
            f"community_spmm_ell_fused_{_DTYPES[ell_blocks.dtype]}",
            [ell_blocks, ell_offsets, ell_mask, row_counts, nbr_counts,
             z_plane, w, out], [k, d, n_pad, c_in, c_out], device)
    fused_launches += 1
    return out


def community_spmm(a_row: torch.Tensor, z_all: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Σ_r [mask[m,r] ≠ 0] · a_row[m,r] @ z_all[r] on the card: the ELL
    kernel's dense addressing (slot r is block r, live where its mask is
    nonzero), with ``ell_layout``'s tile for f32 blocks.  A block whose
    mask is 0 is never read.

    a_row: (k, M, n_pad, n_pad) f32
    z_all: (M, n_pad, C) f32
    mask:  (k, M) int32 — nonzero = live block
    returns (k, n_pad, C) f32
    """
    global dense_launches
    device = _cuda_device("community_spmm", z_all)
    if a_row.dim() != 4 or z_all.dim() != 3:
        raise ValueError(f"expected a_row (k, M, n, n) and z_all (M, n, C), "
                         f"got {tuple(a_row.shape)} and "
                         f"{tuple(z_all.shape)}")
    k, m_total, n_pad, _ = a_row.shape
    c = z_all.shape[2]
    _check("a_row", a_row, (k, m_total, n_pad, n_pad), (torch.float32,),
           device)
    _check("z_all", z_all, (m_total, n_pad, c), (torch.float32,), device)
    _check("mask", mask, (k, m_total), _INT, device)
    out = torch.empty((k, n_pad, c), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("community_spmm", LIB, "community_spmm_dense_f32",
            [a_row, z_all, mask, out], [k, m_total, n_pad, c], device)
    dense_launches += 1
    return out
