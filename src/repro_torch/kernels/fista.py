"""Launcher for the hand-written Hopper FISTA prox of the last layer's Z.

``csrc/fista_lanes.cu`` solves eq. (7) on every community lane — the
masked cross-entropy plus the linear and quadratic terms, by
``fista_iters`` FISTA steps with Lipschitz backtracking — in one launch:
one thread-block cluster a lane, every lane-wide sum and every
backtracking decision on the card.  A lane's rows stay in its blocks'
shared memory where they fit (up to 8,896 rows at C = 10) and in a global
workspace this launcher allocates past that, so the kernel takes every
lane size.  It stands in for the host loop of ``core.parallel.fista_lanes``
(its plain version, which runs on the CPU and without ``use_kernel``) and
replaces no TPU kernel: the reference runs the loop as one XLA program.

``layout`` mirrors the CUDA source's launch geometry (blocks a cluster,
rows a block, threads, shared memory and residency, by the lane's shape
alone), so that ``spec`` builds the launch's ``LaunchSpec`` without a card
(the op trace records it on the CPU as on the card, and the kernel rules
read it); ``community_spmm.query_layout`` asks the built library for the
same words, and the card tests hold the two equal.  ``fista_lanes``
checks the operands, allocates the outputs and launches on the current
CUDA stream without a sync; ``launches`` counts every call that reaches
the kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.analysis import trace
from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand
from repro_torch.kernels.community_spmm import (FISTA_QUERY, LaunchSpec,
                                                Operand)

LIB = "fista_lanes"
SYMBOL = "fista_lanes_f32"
ERRORS = "fista_lanes_error_string"
launches = 0

# the CUDA source's constants: the portable cluster size, rows a block
# before the cluster grows, threads a block, lane-wide sums reduced
# together, the dynamic shared memory a block can take
MAX_CLUSTER, ROWS_TARGET, MAX_THREADS, NSUM = 8, 512, 1024, 4
SMEM_LIMIT = 232448
_SCRATCH = (MAX_THREADS // 32 * NSUM + 3 * NSUM) * 8   # f64 sums' bytes
# the least f32 operations a row entry takes in one FISTA step (an exp or
# a log counted as one): the value and gradient at y (20), one probe (11;
# a step probes at least once) and the momentum update (5)
FLOPS_PER_ENTRY = 36
_F32, _I32 = (torch.float32,), (torch.int32,)


@functools.lru_cache(maxsize=64)
def layout(n: int, c: int) -> dict:
    """The launch at ``n`` rows of width ``c`` a lane, as ``layout_of`` in
    the CUDA source computes it: ``cluster`` blocks a lane (⌈n / 512⌉, at
    most 8), ``rows`` a block (⌈n / cluster⌉), ``threads`` a block (rows
    rounded up to a warp, at most 1,024).  A block's rows take 4 (5C + 2)
    bytes each (Y, Z, B, U, G, the mask and the label): ``resident`` where
    they fit beside the f64 sums' scratch in shared memory, and then
    ``smem_bytes`` is both; else ``smem_bytes`` is the scratch alone and
    ``work`` the workspace floats a lane (0 where resident)."""
    cl = min(MAX_CLUSTER, max(1, -(-n // ROWS_TARGET)))
    rows = -(-n // cl)
    threads = min(MAX_THREADS, max(32, -(-rows // 32) * 32))
    arrays = rows * (5 * c + 2)
    resident = _SCRATCH + 4 * arrays <= SMEM_LIMIT
    return {"cluster": cl, "rows": rows, "threads": threads,
            "resident": resident,
            "smem_bytes": _SCRATCH + 4 * arrays if resident else _SCRATCH,
            "work": 0 if resident else cl * arrays}


def work(k: int, n: int, c: int, iters: int) -> tuple[float, float]:
    """(FLOPs, bytes) one launch needs at least: ``FLOPS_PER_ENTRY`` a row
    entry a step, and B, U, Z_init, the labels and the mask read and Z
    written once."""
    return (float(FLOPS_PER_ENTRY * iters * k * n * c),
            float(4 * k * n * (4 * c + 2)))


def spec(k: int, n: int, c: int, iters: int) -> LaunchSpec:
    """The launch on (k, n, C) lanes: grid (cluster, 1, k), one cluster a
    lane covering its (n, C) output.  Its operands in the C entry's order;
    the workspace (the kernel's scratch where the rows are not resident,
    ``layout``'s ``work``) and the per-lane statistics (null in the
    trainer's launches) are left out, so that the plain version on the CPU
    records the same event."""
    lay = layout(n, c)
    args = (Operand("b", (k, n, c), 4), Operand("u", (k, n, c), 4),
            Operand("labels", (k, n), 4, role="table"),
            Operand("mask", (k, n), 4), Operand("z_init", (k, n, c), 4),
            Operand("denom", (), 4), Operand("out", (k, n, c), 4, role="out"))
    return LaunchSpec(
        name="fista_lanes", lib=LIB, symbol=SYMBOL, args=args,
        ints=(k, n, c), grid=(lay["cluster"], 1, k), threads=lay["threads"],
        smem_bytes=lay["smem_bytes"], tile=(n, c), mask="mask",
        query_symbol=FISTA_QUERY, query=(n, c),
        flops=work(k, n, c, iters)[0], cluster=lay["cluster"])


def check_operands(b, u, labels, mask, z_init, denom,
                   device: torch.device) -> tuple[int, int, int]:
    """Raise on what the kernel does not take; return (k, n, C)."""
    if z_init.dim() != 3:
        raise ValueError(f"expected z_init (k, n, C), got "
                         f"{tuple(z_init.shape)}")
    k, n, c = z_init.shape
    if not (1 <= k <= 65535 and n >= 1 and c >= 1):
        raise ValueError(f"the kernel takes 1 to 65,535 lanes of at least "
                         f"one row and column, got {(k, n, c)}")
    for name, t in (("b", b), ("u", u), ("z_init", z_init)):
        check_operand(name, t, (k, n, c), _F32, device)
    check_operand("labels", labels, (k, n), _I32, device)
    check_operand("mask", mask, (k, n), _F32, device)
    check_operand("denom", denom, (), _F32, device)
    return k, n, c


def fista_lanes(b: torch.Tensor, u: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, z_init: torch.Tensor,
                denom: torch.Tensor, *, rho: float, growth: float,
                rtol: float, max_backtracks: int, iters: int,
                stats: bool = False
                ) -> tuple[torch.Tensor, "torch.Tensor | None",
                           "torch.Tensor | None"]:
    """Eq. (7) on every lane, on the card.

    b, u, z_init: (k, n, C) f32; labels (k, n) int32 in [0, C); mask (k, n)
    f32; denom a 0-dim f32 (the cross-entropy's divisor).  Returns Z_L (k,
    n, C) and, with ``stats``, each lane's Lipschitz constant after its last
    step (k,) f32 and its number of probes (k,) int32 (else None), all on
    the device, unread."""
    global launches
    device = build.cuda_device("fista_lanes", z_init)
    k, n, c = check_operands(b, u, labels, mask, z_init, denom, device)
    if max_backtracks < 0 or iters < 0:
        raise ValueError(f"max_backtracks {max_backtracks} and iters "
                         f"{iters} must not be negative")
    lay = layout(n, c)
    out = torch.empty_like(z_init)
    ws = (None if lay["resident"] else
          torch.empty((k, lay["work"]), dtype=torch.float32, device=device))
    lip = probes = None
    if stats:
        lip = torch.empty((k,), dtype=torch.float32, device=device)
        probes = torch.empty((k,), dtype=torch.int32, device=device)
    build.launch("fista_lanes", LIB, SYMBOL,
                 [b, u, labels, mask, z_init, denom, ws, lip, probes, out],
                 [k, n, c, int(max_backtracks), int(iters), float(0.5 * rho),
                  float(growth), float(rtol), float(rho + 1.0)], device,
                 ERRORS)
    launches += 1
    if trace.RECORDER is not None:
        trace.RECORDER.kernel(spec(k, n, c, int(iters)), dict(
            b=b, u=u, labels=labels, mask=mask, z_init=z_init, denom=denom,
            out=out), "cuda")
    return out, lip, probes
