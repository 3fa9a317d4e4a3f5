"""Kernel rules: every launch addresses inside its operands, fits a
block's shared memory, and copies at the width its operands allow.

The port's counterparts of ``repro.analysis.rules.pallas``.  They never run
a kernel: they read the declarative ``LaunchSpec`` each launcher builds its
launch from (``kernels.community_spmm``) with the index tables the launch
reads, from two places — the expectations' ``kernels`` entries (one per
shard, host tables, as the reference's ``trainer_expectations`` has them)
and the trace's kernel events (the launches the step made, with their
tables).  The TPU's quanta (8-row tiles, 128 lanes, 16 MiB of VMEM) do not
carry over; a Hopper block has 227 KB of shared memory and copies 16 bytes
a thread where its rows allow.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import AnalysisContext, rule
from repro_torch.kernels import community_spmm

# the shared memory an H100 block may opt into (227 KB, the launchers'
# limit), used when no card is present to ask
SMEM_BYTES = community_spmm._SMEM_LIMIT


def smem_limit() -> int:
    """The per-block opt-in shared memory the card reports, or 227 KB."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).shared_memory_per_block_optin)
    return SMEM_BYTES


def _host(x: Any) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_kernel_bounds(spec: Any,
                        tables: Optional[Mapping[str, Any]] = None
                        ) -> List[Finding]:
    """The grid covers the output and its corner blocks start inside it,
    and every live slot's table value addresses inside its operand: an
    index below the operand's leading extent, or a first row whose rows
    (``nbr_counts``) end inside it.  Importable directly (tests hand-build
    bad tables); the registry rule wraps it."""
    findings: list[Finding] = []
    tables = tables or {}
    _, n_rows, n_cols = spec.operand("out").shape
    gx, gy, _ = spec.grid
    col_tiles = gx // max(spec.cluster, 1)
    rows_t, cols_t = spec.tile
    if (col_tiles * cols_t < n_cols or gy * rows_t < n_rows
            or (col_tiles - 1) * cols_t >= n_cols
            or (gy - 1) * rows_t >= n_rows):
        findings.append(Finding(
            "kernel/index-bounds", Severity.ERROR,
            f"{spec.name}: grid {spec.grid} of {spec.tile} tiles does not "
            f"cover the ({n_rows}, {n_cols}) output exactly",
            location=f"{spec.name}:out",
            details={"grid": list(spec.grid), "tile": list(spec.tile)}))
    mask = _host(tables.get(spec.mask))
    for op in spec.args:
        vals = _host(tables.get(op.table)) if op.table else None
        if vals is None:
            continue
        live = (mask != 0) if mask is not None else np.ones(vals.shape, bool)
        v = vals[live].astype(np.int64)
        if not v.size:
            continue
        counts = _host(tables.get(op.rows)) if op.rows else None
        n = (counts[live].astype(np.int64) if counts is not None
             else np.full(v.shape, op.shape[1] if op.addressing == "index"
                          else 1))
        if op.addressing == "index":
            bad = (v < 0) | (v >= op.shape[0]) | (n > op.shape[1])
            limit = f"[0, {op.shape[0]}) with at most {op.shape[1]} rows"
        else:
            bad = (v < 0) | (v + n > op.shape[0])
            limit = f"rows [0, {op.shape[0]})"
        if bad.any():
            j = int(np.flatnonzero(bad)[0])
            findings.append(Finding(
                "kernel/index-bounds", Severity.ERROR,
                f"{spec.name}:{op.name} addressed through {op.table} value "
                f"{int(v[j])} (+{int(n[j])} rows) out of range: {limit}",
                location=f"{spec.name}:{op.name}",
                details={"table": op.table, "index": int(v[j]),
                         "rows": int(n[j]), "extent": list(op.shape),
                         "bad_slots": int(bad.sum())}))
    return findings


def check_kernel_smem(spec: Any, limit: Optional[int] = None
                      ) -> List[Finding]:
    """The spec's shared memory per block fits the card's opt-in limit."""
    limit = smem_limit() if limit is None else int(limit)
    if spec.smem_bytes > limit:
        return [Finding(
            "kernel/smem-budget", Severity.ERROR,
            f"{spec.name}: {spec.smem_bytes} B of shared memory per block "
            f"exceeds the card's {limit} B",
            location=spec.name,
            details={"smem_bytes": int(spec.smem_bytes), "limit": limit,
                     "grid": list(spec.grid), "cluster": spec.cluster})]
    return []


def check_copy_alignment(spec: Any) -> List[Finding]:
    """Operands staged by ``cp.async`` whose pointer or row stride is not
    16-byte aligned, so the kernel copies them 4 (or 2) bytes at a time
    where the same tile copies 16 on aligned rows."""
    findings: list[Finding] = []
    for op in spec.args:
        if op.copy_bytes < op.copy_best:
            row = op.shape[-1] * op.itemsize
            findings.append(Finding(
                "kernel/copy-alignment", Severity.WARNING,
                f"{spec.name}:{op.name} rows of {row} B (alignment "
                f"{op.align} B) take {op.copy_bytes}-byte cp.async copies "
                f"instead of 16-byte ones",
                location=f"{spec.name}:{op.name}",
                details={"row_bytes": row, "align": op.align,
                         "copy_bytes": op.copy_bytes}))
    return findings


def kernel_entries(ctx: AnalysisContext) -> Iterator[tuple[Any, Mapping]]:
    """(spec, tables) of every expectation entry and every distinct kernel
    event of the trace."""
    for k in ctx.expectations.get("kernels") or ():
        yield k["spec"], k.get("scalars") or {}
    seen = set()
    for e in (ctx.trace.of_kind("kernel") if ctx.trace is not None else ()):
        tables = e.info.get("tables") or {}
        key = (e.info["spec"], tuple(id(t) for t in tables.values()))
        if key not in seen:
            seen.add(key)
            yield e.info["spec"], tables


def _distinct_specs(ctx: AnalysisContext) -> list:
    return list(dict.fromkeys(s for s, _ in kernel_entries(ctx)))


@rule("kernel/index-bounds")
def index_bounds(ctx: AnalysisContext) -> Iterable[Finding]:
    """Each launch's grid corners and live table values address inside
    its operands."""
    for spec, tables in kernel_entries(ctx):
        yield from check_kernel_bounds(spec, tables)


@rule("kernel/smem-budget")
def smem_budget(ctx: AnalysisContext) -> Iterable[Finding]:
    """Each launch's shared memory fits a block's opt-in limit."""
    limit = ctx.expectations.get("smem_limit")
    for spec in _distinct_specs(ctx):
        yield from check_kernel_smem(spec, limit)


@rule("kernel/copy-alignment", severity=Severity.WARNING)
def copy_alignment(ctx: AnalysisContext) -> Iterable[Finding]:
    """Operands staged by cp.async allow 16-byte copies."""
    for spec in _distinct_specs(ctx):
        yield from check_copy_alignment(spec)
