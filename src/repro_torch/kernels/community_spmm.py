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

Every launch is built from a declarative ``LaunchSpec`` (``ell_spec``,
``ell_packed_spec``, ``ell_fused_spec``, ``spmm_spec``; the counterparts of
the reference's ``KernelSpec`` builders): the C entry and its pointer and
int arguments, the grid, threads, cluster and shared memory, the copy
width of each operand, and each operand's extent with the index table that
addresses it.  The launcher and the static checks
(``repro_torch.analysis.rules.kernel``) read the same object.  The CUDA
layout queries stay the source of truth for the launch geometry:
``ell_layout`` mirrors ``community_spmm_ell_layout`` (the tile
configuration the ELL / packed / dense kernel picks), ``fused_cluster``,
``fused_grid`` and ``fused_smem_bytes`` mirror
``community_spmm_ell_fused_layout`` (so that the width limit is refused
here), and ``query_layout`` asks the built library for a spec's words
(the card tests hold each spec equal to its query).  ``operand_layout``
reads ``ell_layout`` off a launch's operands.

The launchers read no values from the device: the indices of live slots
must lie in ``[0, M)`` and the plane rows a live packed slot reads must lie
inside the plane, which ``check_indices`` and ``check_plane_offsets`` verify
once where the tables are built (``core.parallel.community_data``,
``serve.engine.CommunityServer``), not on every launch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.analysis import trace
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
_BYTES_DT = {4: "f32", 2: "bf16"}
_INT = (torch.int32,)
# the fused kernel spreads a 32-row tile's (32, C_in) f32 aggregate over a
# cluster of up to 8 blocks in 128-column chunks; each block holds its
# chunks (16 KB each) and 21,504 bytes of staging tiles in shared memory
_FUSED_ROWS, _FUSED_CHUNK, _FUSED_MAX_CLUSTER = 32, 128, 8
_FUSED_THREADS = 256
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


@dataclasses.dataclass(frozen=True)
class Operand:
    """One pointer argument of a launch, in the C entry's order.

    ``role`` is "data", "table" (an int32 index table) or "out".  A data
    operand read through a table names it: with ``addressing="index"`` a
    live slot's value selects one leading entry of ``shape`` (a community of
    z_all), with ``"rows"`` it is the first of the rows the slot reads, and
    ``rows`` names the table of how many rows (``nbr_counts``).
    ``copy_bytes`` is the ``cp.async`` width the kernel stages it with (0:
    not staged) and ``copy_best`` the width the same tile takes on rows
    aligned to 16 bytes; ``align`` is the largest power of two up to 16
    dividing its pointer and row stride (``copy_align``)."""
    name: str
    shape: tuple[int, ...]
    itemsize: int
    role: str = "data"
    table: Optional[str] = None
    addressing: str = ""
    rows: Optional[str] = None
    copy_bytes: int = 0
    copy_best: int = 0
    align: int = 16


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One launch of a hand-written kernel, as its launcher makes it.

    ``args`` are the C entry's pointers in order (the output last) and
    ``ints`` its int arguments; ``grid`` is (x, y, z) blocks of ``threads``,
    ``cluster`` blocks per cluster along x, ``smem_bytes`` the shared memory
    one block takes; ``tile`` the (rows, columns) of output a block (the
    fused kernel: a cluster) covers.  ``mask`` names the table whose
    nonzero entries are the live slots.  ``query`` are the arguments of the
    library's layout query and ``layout_words()`` what it must answer.
    ``flops`` is the work of every slot at full rows (2 per multiply-add)."""
    name: str
    lib: str
    symbol: str
    args: tuple[Operand, ...]
    ints: tuple[int, ...]
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    tile: tuple[int, int]
    mask: str
    query_symbol: str
    query: tuple[int, ...]
    flops: float
    cluster: int = 1
    stages: int = 0
    thread_tile: tuple[int, int] = (0, 0)
    accumulate: str = "float32"

    @property
    def table_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.args if a.role == "table")

    def operand(self, name: str) -> Operand:
        return next(a for a in self.args if a.name == name)

    def layout_words(self) -> tuple[int, ...]:
        """What the layout query answers for this launch."""
        if self.query_symbol == FUSED_QUERY:
            return (self.cluster, self.tile[0], self.smem_bytes)
        if self.query_symbol == FISTA_QUERY:      # a cluster covers a lane
            return (self.cluster, -(-self.tile[0] // self.cluster),
                    self.threads, self.smem_bytes)
        blocks = self.args[0]
        z = next(a for a in self.args if a.role == "data" and a is not blocks)
        return (self.tile[0], self.tile[1], *self.thread_tile, self.stages,
                *self.grid, self.smem_bytes, blocks.copy_bytes, z.copy_bytes)


ELL_QUERY = "community_spmm_ell_layout"
FUSED_QUERY = "community_spmm_ell_fused_layout"
FISTA_QUERY = "fista_lanes_layout"     # kernels.fista's launches


def _ell_launch(name: str, symbol: str, blocks: Operand, tables: tuple,
                z: Operand, mask: str, dense: bool = False) -> LaunchSpec:
    """A launch of ``community_spmm_ell.cu``: ``ell_layout``'s tile for
    these widths and alignments.  Pointers: the blocks, the tables, z and
    the output (the dense entry: the blocks, z, its mask, the output)."""
    k, d, n_pad, _ = blocks.shape
    c = z.shape[-1]
    lay = ell_layout(k, n_pad, c, blocks.itemsize, z.align, blocks.align)
    best = ell_layout(k, n_pad, c, blocks.itemsize, 16, 16)
    blocks = dataclasses.replace(blocks, copy_bytes=lay["a_copy"],
                                 copy_best=best["a_copy"])
    z = dataclasses.replace(z, copy_bytes=lay["z_copy"],
                            copy_best=best["z_copy"])
    out = Operand("out", (k, n_pad, c), 4, role="out")
    return LaunchSpec(
        name=name, lib=LIB, symbol=symbol,
        args=(blocks, z, *tables, out) if dense
        else (blocks, *tables, z, out),
        ints=(k, d, n_pad, c), grid=lay["grid"], threads=lay["threads"],
        smem_bytes=lay["smem_bytes"], tile=(lay["bm"], lay["bn"]),
        mask=mask, query_symbol=ELL_QUERY,
        query=(k, n_pad, c, blocks.itemsize, z.align, blocks.align),
        flops=2.0 * k * d * n_pad * n_pad * c, stages=lay["stages"],
        thread_tile=(lay["tm"], lay["tn"]))


def _ell_tables(first: str, k: int, d: int) -> tuple:
    """The ELL entries' tables: the slot table ``first`` (indices or
    offsets), the mask, the row and neighbour counts."""
    i32 = dict(itemsize=4, role="table")
    return (Operand(first, (k, d), **i32), Operand("ell_mask", (k, d), **i32),
            Operand("row_counts", (k,), **i32),
            Operand("nbr_counts", (k, d), **i32))


@functools.lru_cache(maxsize=512)
def ell_spec(k: int, d: int, n_pad: int, c: int, m_z: int, *,
             block_bytes: int = 4, z_align: int = 16,
             a_align: int = 16) -> LaunchSpec:
    """The strided ELL launch: lane m's slot d reads rows [0, nbr_counts)
    of z_all[ell_indices[m, d]], z_all (m_z, n_pad, C) f32."""
    return _ell_launch(
        "community_spmm_ell", f"community_spmm_ell_{_BYTES_DT[block_bytes]}",
        Operand("ell_blocks", (k, d, n_pad, n_pad), block_bytes,
                align=a_align),
        _ell_tables("ell_indices", k, d),
        Operand("z_all", (m_z, n_pad, c), 4, table="ell_indices",
                addressing="index", rows="nbr_counts", align=z_align),
        "ell_mask")


@functools.lru_cache(maxsize=512)
def ell_packed_spec(k: int, d: int, n_pad: int, c: int, plane_rows: int, *,
                    block_bytes: int = 4, z_align: int = 16,
                    a_align: int = 16) -> LaunchSpec:
    """The packed launch: lane m's slot d reads plane rows [ell_offsets[m,
    d], + nbr_counts[m, d]) of the (plane_rows, C) f32 plane."""
    return _ell_launch(
        "community_spmm_ell_packed",
        f"community_spmm_ell_packed_{_BYTES_DT[block_bytes]}",
        Operand("ell_blocks", (k, d, n_pad, n_pad), block_bytes,
                align=a_align),
        _ell_tables("ell_offsets", k, d),
        Operand("z_plane", (plane_rows, c), 4, table="ell_offsets",
                addressing="rows", rows="nbr_counts", align=z_align),
        "ell_mask")


@functools.lru_cache(maxsize=512)
def spmm_spec(k: int, m: int, n_pad: int, c: int, *, z_align: int = 16,
              a_align: int = 16) -> LaunchSpec:
    """The dense launch: lane i's slot r is block r of its row, live where
    mask[i, r] != 0, reading z_all[r]; f32 blocks, ``ell_layout``'s tile."""
    return _ell_launch(
        "community_spmm", "community_spmm_dense_f32",
        Operand("a_row", (k, m, n_pad, n_pad), 4, align=a_align),
        (Operand("mask", (k, m), 4, role="table"),),
        Operand("z_all", (m, n_pad, c), 4, align=z_align), "mask",
        dense=True)


@functools.lru_cache(maxsize=512)
def ell_fused_spec(k: int, d: int, n_pad: int, c_in: int, c_out: int,
                   plane_rows: int, *, block_bytes: int = 4) -> LaunchSpec:
    """The fused launch: the packed addressing over a (plane_rows, C_in)
    plane, then @ w (C_in, C_out); one 32-row tile per cluster of
    ``fused_cluster(C_in)`` blocks of 256 threads."""
    i32 = dict(itemsize=4, role="table")
    args = (Operand("ell_blocks", (k, d, n_pad, n_pad), block_bytes),
            Operand("ell_offsets", (k, d), **i32),
            Operand("ell_mask", (k, d), **i32),
            Operand("row_counts", (k,), **i32),
            Operand("nbr_counts", (k, d), **i32),
            Operand("z_plane", (plane_rows, c_in), 4, table="ell_offsets",
                    addressing="rows", rows="nbr_counts"),
            Operand("w", (c_in, c_out), 4),
            Operand("out", (k, n_pad, c_out), 4, role="out"))
    return LaunchSpec(
        name="community_spmm_ell_fused", lib=FUSED_LIB,
        symbol=f"community_spmm_ell_fused_{_BYTES_DT[block_bytes]}",
        args=args, ints=(k, d, n_pad, c_in, c_out),
        grid=fused_grid(k, n_pad, c_in), threads=_FUSED_THREADS,
        smem_bytes=fused_smem_bytes(c_in), tile=(_FUSED_ROWS, c_out),
        mask="ell_mask", query_symbol=FUSED_QUERY, query=(c_in,),
        flops=2.0 * k * n_pad * (d * n_pad * c_in + c_in * c_out),
        cluster=fused_cluster(c_in)[0])


def query_layout(spec: LaunchSpec) -> tuple[int, ...]:
    """The built library's answer to ``spec``'s layout query (needs the
    card's toolchain: it loads the library)."""
    import ctypes
    lib = build.load(spec.lib)
    fn = getattr(lib, spec.query_symbol)
    fn.argtypes = [ctypes.c_int] * len(spec.query) + [
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    words = len(spec.layout_words())
    out = (ctypes.c_int * words)()
    if fn(*spec.query, out) != 0:
        raise ValueError(f"{spec.query_symbol}{spec.query} refused")
    return tuple(out)


def _launch(spec: LaunchSpec, tensors: dict, device: torch.device) -> None:
    """Launch ``spec`` on ``tensors`` (by operand name, the output
    included) on the current stream of ``device``."""
    build.launch(spec.name, spec.lib, spec.symbol,
                 [tensors[a.name] for a in spec.args], list(spec.ints),
                 device, "community_spmm_error_string")
    if trace.RECORDER is not None:
        trace.RECORDER.kernel(spec, tensors, "cuda")


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
    bb = ell_blocks.element_size()
    spec = ell_spec(k, d, n_pad, c, m_total, block_bytes=bb,
                    z_align=copy_align(z_all.data_ptr(), 4 * c),
                    a_align=copy_align(ell_blocks.data_ptr(), bb * n_pad))
    _launch(spec, dict(ell_blocks=ell_blocks, ell_indices=ell_indices,
                       ell_mask=ell_mask, row_counts=row_counts,
                       nbr_counts=nbr_counts, z_all=z_all, out=out), device)
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
    bb = ell_blocks.element_size()
    spec = ell_packed_spec(
        k, d, n_pad, c, z_plane.shape[0], block_bytes=bb,
        z_align=copy_align(z_plane.data_ptr(), 4 * c),
        a_align=copy_align(ell_blocks.data_ptr(), bb * n_pad))
    _launch(spec, dict(ell_blocks=ell_blocks, ell_offsets=ell_offsets,
                       ell_mask=ell_mask, row_counts=row_counts,
                       nbr_counts=nbr_counts, z_plane=z_plane, out=out),
            device)
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
    spec = ell_fused_spec(k, d, n_pad, c_in, c_out, z_plane.shape[0],
                          block_bytes=ell_blocks.element_size())
    _launch(spec, dict(ell_blocks=ell_blocks, ell_offsets=ell_offsets,
                       ell_mask=ell_mask, row_counts=row_counts,
                       nbr_counts=nbr_counts, z_plane=z_plane, w=w, out=out),
            device)
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
    spec = spmm_spec(k, m_total, n_pad, c,
                     z_align=copy_align(z_all.data_ptr(), 4 * c),
                     a_align=copy_align(a_row.data_ptr(), 4 * n_pad))
    _launch(spec, dict(a_row=a_row, z_all=z_all, mask=mask, out=out), device)
    dense_launches += 1
    return out
