"""Parallel (community-distributed) ADMM trainer — Algorithm 1.

The port's counterpart of ``repro.core.parallel``.  M community agents run
over ``n_shards`` shards (k = M / n_shards lanes each), through one of two
transports: the loopback, where every shard is a logical shard of one
device and the shards' lanes are stacked in community order, so every
aggregation of a step is one call over all M lanes; or the process
transport (``mesh=ProcessMesh``), where each shard is a process of a
``torch.distributed`` group that holds its own k lanes and exchanges rows
with the others.  One body (``_Body``) runs both.  One ADMM iteration:

  * W update — layer-parallel (Jacobi): each shard's objective over its
    lanes, summed across shards in shard order (the reference's psum: a
    Python sum on the loopback, an all-gather and the same sum across
    processes), and one backtracking test on that global objective
    (``subproblems.backtracking_step``, with ``psum`` on a rank).
  * Z update — community-parallel: each lane solves its ψ_{l,m} (eq. 5/6)
    from its neighbours' relayed aggregates with its own backtracking
    θ_{l,m} (``backtracking_step_lanes``); Z_L by per-lane FISTA (eq. 7,
    ``fista_lanes``).  Neither runs a collective.  Under ``use_kernel``
    on a CUDA device the Z_L prox is one launch of
    ``csrc/fista_lanes.cu`` (``kernels.ops.fista_lanes``), every FISTA
    step and backtrack on the card with no host read, at every lane size;
    on the CPU and with ``use_kernel=False`` the plain host loop runs.
  * U update — local dual ascent (eq. 3).

Transports (``messages``; each round of the reference's ``ppermute``
schedule is a row copy between the shards' buffers on the loopback, one
``batch_isend_irecv`` between ranks on the process transport):

  * allgather — every shard receives every community's rows; with
    ``comm_bf16`` every row is rounded to bf16;
  * p2p — the neighbour-exchange plan: each shard receives only the rows
    its lanes read, into an (r_pad, n_pad, C) buffer; ELL indices are
    remapped to its slots; with ``comm_bf16`` only wired rows are rounded;
  * the packed wire (``packed=True``) — the same rounds on Σ-bucket-rows
    planes into the shards' receive planes (on the loopback laid end to
    end, shard s's offsets shifted by s · recv_plane_rows), which the
    packed ELL kernel reads through per-slot offsets.  ``fused=True``
    sends the four Z-update aggregation→GEMM sites through the fused
    kernel; ``overlap=True`` splits each aggregation by the round that
    delivered its rows.

With one shard nothing crosses a wire: the reference drops the plan from
its one-shard program (repro/core/parallel.py:1023-1028), so the step is
the all-gather body, ``fused`` and ``overlap`` are inert, and the plan
only prices the p2p accounting (``comm_stats``).

Every aggregation runs over one of two adjacency representations, either
through a hand-written CUDA kernel (``use_kernel=True``) or a plain einsum:
dense (``compressed=False``) through ``kernels.ops.community_spmm``, or
block-compressed ELL through ``community_spmm_ell`` (strided buffers) or
``community_spmm_ell_packed`` / ``community_spmm_ell_fused`` (packed
planes).  ``batch_fraction`` samples shard batches
(``sharding.partition.CommunityBatchSampler``): the step runs the plan
restricted to the sampled shards, unsampled lanes keep their iterates, and
stale neighbours' coupling terms are damped by ``stale_decay``.

Each ``lax.while_loop`` of the reference is a host loop with the same
acceptance test; each ``lax.scan`` a Python loop (the Z_L prox's, on the
kernel route, a loop inside the kernel).  Gradients come from autograd
(the FISTA kernel's in closed form); the aggregates reach every objective
as constants, so no gradient flows through the kernel.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core import gcn, graph, messages
from repro_torch.core.serial import TrainLog
from repro_torch.core.subproblems import (ADMMConfig, backtracking_step,
                                          stale_weights, value_and_grad)
from repro_torch.kernels import community_spmm, ref
from repro_torch.kernels import ops as kops
from repro_torch.sharding import partition
from repro_torch.util.device import resolve_device

Tensor = torch.Tensor


class ParallelState(NamedTuple):
    """Trainer iterates.  Strided layout: zs[l] is (M, n_pad, C_l) and u
    (M, n_pad, C_L).  Packed layout: zs[l] is the (plane_rows, C_l)
    Σ-bucket-rows plane (u likewise)."""
    weights: tuple[Tensor, ...]
    zs: tuple[Tensor, ...]
    u: Tensor
    taus: tuple[Tensor, ...]     # 0-dim f32
    thetas: tuple[Tensor, ...]   # (M,) f32


@dataclasses.dataclass(frozen=True)
class CommunityData:
    """Device-ready community-blocked graph tensors.

    Exactly one adjacency representation is resident: dense mode holds
    ``a_blocks`` (M, M, n_pad, n_pad); compressed mode holds only the ELL
    view ``ell_blocks``/``ell_indices``/``ell_mask`` (graph.BlockCSR) and
    ``a_blocks`` is None.  With ``adjacency_bf16=True`` (compressed only) the
    ELL block store is bf16; aggregation accumulates in f32.

    ``row_counts``/``nbr_counts`` carry the ragged (bucketed) per-lane and
    per-neighbour padded row counts the ELL kernel's row guards key off;
    ``row_mask`` masks blocked (M, n_pad) tensors down to true rows.  With
    ``packed_layout`` set, z0 / labels / train_mask / test_mask are stored
    as Σ-bucket-rows planes (total_rows, …).
    """
    a_blocks: "Tensor | None"
    z0: Tensor
    labels: Tensor
    train_mask: Tensor
    test_mask: Tensor
    neighbor_mask: Tensor
    denom: Tensor
    row_mask: Tensor
    ell_blocks: "Tensor | None" = None
    ell_indices: "Tensor | None" = None
    ell_mask: "Tensor | None" = None
    row_counts: "Tensor | None" = None
    nbr_counts: "Tensor | None" = None
    packed_layout: "graph.PackedDeviceLayout | None" = None

    @property
    def compressed(self) -> bool:
        return self.a_blocks is None

    @property
    def packed(self) -> bool:
        return self.packed_layout is not None

    @property
    def adjacency_bf16(self) -> bool:
        return (self.ell_blocks is not None
                and self.ell_blocks.dtype == torch.bfloat16)

    @property
    def num_parts(self) -> int:
        if self.packed_layout is not None:
            return self.packed_layout.num_parts
        return int(self.z0.shape[0])

    @property
    def adjacency_nbytes(self) -> int:
        """Device-resident adjacency bytes of this representation."""
        def nbytes(t):
            return t.numel() * t.element_size()
        if self.compressed:
            return (nbytes(self.ell_blocks) + nbytes(self.ell_indices)
                    + nbytes(self.ell_mask))
        return nbytes(self.a_blocks)


# per-lane fields of CommunityData, and the fields stored as state planes
_LANE_FIELDS = ("a_blocks", "neighbor_mask", "row_mask", "ell_blocks",
                "ell_indices", "ell_mask", "row_counts", "nbr_counts")
_PLANE_FIELDS = ("z0", "labels", "train_mask", "test_mask")


def _lane_fields(fields: dict, lanes: slice,
                 device_layout: "graph.PackedDeviceLayout | None") -> dict:
    """One shard's part of the per-lane and plane fields (numpy arrays or
    tensors): ``lanes`` of the lane axis, and of a packed plane the
    shard's ``plane_rows`` rows."""
    out = {}
    for name in _LANE_FIELDS:
        if fields.get(name) is not None:
            out[name] = fields[name][lanes]
    rows = lanes
    if device_layout is not None:
        s = lanes.start // (lanes.stop - lanes.start)
        pr = device_layout.plane_rows
        rows = slice(s * pr, (s + 1) * pr)
    for name in _PLANE_FIELDS:
        out[name] = fields[name][rows]
    return out


def lane_data(data: CommunityData, lanes: slice) -> CommunityData:
    """The shard of ``data`` that hosts ``lanes``: its lanes' adjacency
    rows, masks and counts, and its part of the planes, as views."""
    fields = {name: getattr(data, name)
              for name in _LANE_FIELDS + _PLANE_FIELDS}
    return dataclasses.replace(
        data, **_lane_fields(fields, lanes, data.packed_layout))


def community_data(g: graph.Graph, layout: graph.CommunityLayout,
                   compressed: bool = False,
                   adjacency_bf16: bool = False,
                   device_layout: "graph.PackedDeviceLayout | None" = None,
                   device: "str | torch.device | None" = None,
                   lanes: "slice | None" = None) -> CommunityData:
    """The device tensors of every lane, or with ``lanes`` of one shard's
    lanes only (sliced on the host: nothing else reaches the device)."""
    if adjacency_bf16 and not compressed:
        raise ValueError("adjacency_bf16=True requires compressed=True — "
                         "only the ELL block store has a bf16 path")
    if device_layout is not None and not compressed:
        raise ValueError("packed device state requires compressed=True — "
                         "the dense block tensor keeps the n_pad stride")
    device = resolve_device(device)

    if compressed:
        csr = layout.compress()
        rows, nbrs = csr.ell_row_counts()
        # the CUDA kernel reads live indices unchecked: check them once here
        community_spmm.check_indices(torch.as_tensor(csr.ell_indices),
                                     torch.as_tensor(csr.ell_mask),
                                     csr.num_parts)
        host = {"ell_blocks": csr.ell_blocks, "ell_indices": csr.ell_indices,
                "ell_mask": csr.ell_mask, "row_counts": rows,
                "nbr_counts": nbrs}
    else:
        host = {"a_blocks": layout.a_blocks}
    if device_layout is not None:
        # Σ-bucket-rows planes: pad rows outside the bucket counts are
        # zero by the layout contract, so pack is lossless
        def plane(x):
            return device_layout.pack_state(layout.pack(x))
    else:
        plane = layout.pack
    host.update(z0=plane(g.features),
                labels=plane(g.labels.astype(np.int32)),
                train_mask=plane(g.train_mask.astype(np.float32)),
                test_mask=plane(g.test_mask.astype(np.float32)),
                neighbor_mask=layout.neighbor_mask,
                row_mask=layout.node_mask.astype(np.float32))
    if lanes is not None:
        host = _lane_fields(host, lanes, device_layout)
    fields = {name: torch.as_tensor(np.asarray(x), device=device)
              for name, x in host.items()}
    if compressed and adjacency_bf16:
        fields["ell_blocks"] = fields["ell_blocks"].to(torch.bfloat16)
    return CommunityData(
        a_blocks=fields.pop("a_blocks", None),
        denom=torch.tensor(float(g.train_mask.sum()), dtype=torch.float32,
                           device=device),
        packed_layout=device_layout, **fields)


# ---------------------------------------------------------------------------
# trainer configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Every mode flag of ``ParallelADMMTrainer``, validated in one place.

    The same fields, presets and ``ValueError`` messages as
    ``repro.core.parallel.TrainerConfig``: the flags form a dependency
    ladder (packed planes only route through ELL offsets, the row-exact
    exchange only feeds packed planes, sampling only restricts a p2p round
    schedule) and ``__post_init__`` enforces it.  ``transport=None``
    resolves to p2p when compressed and to the all-gather otherwise.
    Configurations this slice of the port does not run are rejected by the
    trainer, not here, so that a configuration stays portable.
    """
    compressed: bool = False
    transport: "str | None" = None
    partitioner: "str | None" = None
    pad_mode: str = "bucketed"
    packed: bool = False
    overlap: bool = False
    fused: bool = False
    comm_bf16: bool = False
    adjacency_bf16: bool = False
    use_kernel: bool = False
    batch_fraction: "float | None" = None
    stale_decay: float = 0.5
    sample_seed: int = 0

    def __post_init__(self):
        transport = self.transport
        if transport is None:
            transport = "p2p" if self.compressed else "allgather"
            object.__setattr__(self, "transport", transport)
        if transport not in ("p2p", "allgather"):
            raise ValueError(f"unknown transport {transport!r}; "
                             f"expected 'p2p' or 'allgather'")
        if transport == "p2p" and not self.compressed:
            raise ValueError("transport='p2p' requires compressed=True — "
                             "the dense Z-coupling reads all M payload rows")
        if self.packed and not self.compressed:
            raise ValueError("packed=True requires compressed=True — the "
                             "packed plane is only routed through ELL "
                             "offsets, never a dense Z-coupling")
        if self.packed and transport != "p2p":
            raise ValueError("packed=True requires transport='p2p' — the "
                             "plane layout exists to feed the row-exact "
                             "exchange; an all-gather would re-materialise "
                             "the strided (M, n_pad, C) payload")
        if self.overlap and not self.packed:
            raise ValueError("overlap=True requires packed=True — the "
                             "staged exchange snapshots are packed planes")
        if self.fused and not self.packed:
            raise ValueError("fused=True requires packed=True — the fused "
                             "aggregation→GEMM kernel reads the packed "
                             "receive plane through ELL offsets")
        if self.pad_mode not in ("global", "bucketed"):
            raise ValueError(f"unknown pad_mode {self.pad_mode!r}; "
                             f"expected 'global' or 'bucketed'")
        if self.adjacency_bf16 and not self.compressed:
            raise ValueError("adjacency_bf16=True requires compressed=True")
        if self.batch_fraction is not None:
            if not 0.0 < self.batch_fraction <= 1.0:
                raise ValueError(f"batch_fraction must be in (0, 1], got "
                                 f"{self.batch_fraction!r}")
            if not self.packed:
                raise ValueError("batch_fraction requires packed=True — "
                                 "the sampled sweep runs on the sampled "
                                 "shards' packed planes")
        if not 0.0 < self.stale_decay <= 1.0:
            raise ValueError(f"stale_decay must be in (0, 1], got "
                             f"{self.stale_decay!r}")

    @classmethod
    def from_cli_args(cls, args) -> "TrainerConfig":
        """Build from an argparse namespace: every flag is read by its
        ``dest`` name, missing attributes keep the field default."""
        kw = {}
        for f in dataclasses.fields(cls):
            if hasattr(args, f.name):
                kw[f.name] = getattr(args, f.name)
        return cls(**kw)


# named presets — attached after the class body because ``packed`` is
# both a field and a constructor name
def _preset_dense(cls, **kw) -> TrainerConfig:
    """The dense-adjacency all-gather baseline."""
    kw.setdefault("compressed", False)
    return cls(**kw)


def _preset_p2p(cls, **kw) -> TrainerConfig:
    """Block-compressed adjacency over the neighbour-only p2p transport."""
    kw.setdefault("compressed", True)
    kw.setdefault("transport", "p2p")
    return cls(**kw)


def _preset_packed(cls, **kw) -> TrainerConfig:
    """Packed Σ-bucket-rows resident state over row-exact p2p."""
    kw.setdefault("compressed", True)
    kw.setdefault("transport", "p2p")
    kw.setdefault("packed", True)
    return cls(**kw)


def _preset_minibatch(cls, batch_fraction: float = 0.25,
                      **kw) -> TrainerConfig:
    """Stochastic community minibatching on the packed trainer."""
    kw.setdefault("compressed", True)
    kw.setdefault("transport", "p2p")
    kw.setdefault("packed", True)
    kw.setdefault("batch_fraction", batch_fraction)
    return cls(**kw)


TrainerConfig.dense = classmethod(_preset_dense)
TrainerConfig.p2p = classmethod(_preset_p2p)
TrainerConfig.packed = classmethod(_preset_packed)
TrainerConfig.minibatch = classmethod(_preset_minibatch)

# the historic flag kwargs the deprecation shim still accepts
_LEGACY_FLAGS = ("use_kernel", "comm_bf16", "compressed", "transport",
                 "partitioner", "pad_mode", "adjacency_bf16", "packed",
                 "overlap")


def gathered_widths(cfg: gcn.GCNConfig) -> list[int]:
    """The feature widths a step gathers, one per transport call: Z_0
    once, Z_1..Z_L, q per hidden layer, then U and the penultimate-Z
    refresh for L >= 2."""
    dims = list(cfg.layer_dims)
    cs = [dims[0]] + dims[1:]
    if cfg.num_layers >= 2:
        cs += dims[2:] + [dims[-1], dims[-2]]
    return cs


# ---------------------------------------------------------------------------
# backtracking primitives
# ---------------------------------------------------------------------------

def _lane_search(accepted, step0: Tensor, admm: ADMMConfig) -> Tensor:
    """Per-lane doubling until every lane accepts (frozen lanes stop): at
    most ``max_backtracks`` doublings, each probe one candidate's
    objective and the read that decides whether to go on."""
    step, done = step0, None
    for i in range(admm.max_backtracks + 1):
        with trace.span("admm.probe", site="lane-search"):
            if done is None:
                done = accepted(step)
            else:
                step = torch.where(done, step, step * admm.backtrack_growth)
                done = done | accepted(step)
            if i == admm.max_backtracks or trace.decide(done.all(),
                                                        "lane-search"):
                break
    return step


def backtracking_step_lanes(obj_lanes, x: Tensor, theta0: Tensor,
                            admm: ADMMConfig) -> tuple[Tensor, Tensor]:
    """Per-lane majorize-minimize step (the paper's per-(l,m) θ search).

    obj_lanes: (k, n, C) -> (k,) per-community objective values.
    x: (k, n, C); theta0: (k,).
    """
    vals, grads = value_and_grad(obj_lanes, x)
    g_sq = torch.sum(grads * grads, dim=(1, 2))

    def accepted(theta):
        bound = vals - 0.5 * g_sq / theta
        tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
        return bound + tol >= obj_lanes(x - grads / theta[:, None, None])

    with torch.no_grad():
        theta0 = torch.clamp(theta0 / admm.backtrack_growth, min=1e-8)
        theta = _lane_search(accepted, theta0, admm)
    return x - grads / theta[:, None, None], theta


def fista_lanes(admm: ADMMConfig, b: Tensor, u: Tensor, labels: Tensor,
                mask: Tensor, z_init: Tensor, denom: Tensor) -> Tensor:
    """Eq. (7) per community lane: R(Z,Y_m) + ⟨U_m, Z−B_m⟩ + ρ/2‖Z−B_m‖²,
    each lane with its own Lipschitz backtracking.

    The plain path: a host loop of autograd gradients and lane searches,
    one host read a probe.  The trainer runs it on the CPU and without
    ``use_kernel``; under ``use_kernel`` on a CUDA device the step runs
    the same algorithm as one launch of ``kernels.ops.fista_lanes``
    instead."""
    lab = labels.long()[..., None]

    def obj_lanes(z):
        logp = torch.log_softmax(z, dim=-1)
        nll = -torch.gather(logp, -1, lab)[..., 0]
        ce = torch.sum(nll * mask, dim=1) / denom
        r = z - b
        lin = torch.sum(u * r, dim=(1, 2))
        quad = 0.5 * admm.rho * torch.sum(r * r, dim=(1, 2))
        return ce + lin + quad

    k = z_init.shape[0]
    z = y = z_init
    t = torch.tensor(1.0, dtype=torch.float32, device=z_init.device)
    lip = torch.full((k,), admm.rho + 1.0, dtype=torch.float32,
                     device=z_init.device)
    for _ in range(admm.fista_iters):
        vals_y, g = value_and_grad(obj_lanes, y)
        g_sq = torch.sum(g * g, dim=(1, 2))

        def accepted(lip, y=y, g=g, vals_y=vals_y, g_sq=g_sq):
            bound = vals_y - 0.5 * g_sq / lip
            tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
            return obj_lanes(y - g / lip[:, None, None]) <= bound + tol

        with torch.no_grad():
            lip = _lane_search(accepted, lip, admm)
            z_new = y - g / lip[:, None, None]
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            y = z_new + ((t - 1.0) / t_new) * (z_new - z)
            z, t, lip = z_new, t_new, lip * 0.9
    return z


# ---------------------------------------------------------------------------
# one ADMM iteration (the hosted shards' lanes)
# ---------------------------------------------------------------------------

def _take_fill(x: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``x`` at ``idx``; an index past the end gives a zero row
    (``jnp.take(..., mode="fill", fill_value=0)``)."""
    valid = idx < x.shape[0]
    rows = x[torch.where(valid, idx, 0)]
    return torch.where(valid.view((-1,) + (1,) * (x.dim() - 1)), rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _Batch(NamedTuple):
    """What a step depends on beyond the trainer's static operands: the
    exchange plan it runs (restricted to the sampled shards under
    minibatching) with its loopback index tables, the ELL slot masks of its
    arrival groups (overlap), and the sampled lanes."""
    plan: "messages.NeighborExchange | None"
    tables: "dict | None"                      # messages.loopback_tables
    group_masks: "tuple[Tensor, ...] | None"   # per arrival group, (M, D)
    smask: "Tensor | None"                     # (M,) f32, 1 = sampled lane


class _Body:
    """The per-step program of the reference's ``_iteration_body`` for the
    shards this process hosts, with its static operands bound: every shard
    under the loopback transport (``messages.Loopback``), one under the
    process transport (``messages.ProcessTransport``, one rank a shard).
    ``data`` holds the hosted lanes only.

    The hosted m = hosted · k lanes are stacked in community order (shard s
    owns lanes [s·k, (s+1)·k)), so every aggregation of the step is one
    call over all of them.  ``gather`` returns what the aggregation reads,
    and ``blocked`` of it stacks every hosted shard's received rows, (X,
    n_pad, C), which ``nbr_idx`` reads lane by lane — X = M after the
    all-gather (one copy serves every shard; ``nbr_idx`` the global ids),
    hosted · r_pad after the exchange (the loopback's localized slots
    shifted by s · r_pad).  On the packed wire ``gather`` returns the
    hosted shards' receive planes laid end to end (their stages, with
    overlap), read through ``offsets``: the plan's localized offsets,
    shifted by s · recv_plane_rows on the loopback; their blocked view is
    made only where a consumer indexes it.

    The W update's objective is the hosted shards' sum (``shard_sum``).
    On the loopback that is the global objective; a rank psums its local
    one through the transport (``psum``: value, gradient and every probe,
    the reference's ``backtracking_step_psum``).  The θ searches and FISTA
    read a lane's own rows only and run no collective.

    With one shard there is no plan (the reference drops it there) and the
    step runs the all-gather body.
    """

    def __init__(self, cfg: gcn.GCNConfig, admm: ADMMConfig,
                 data: CommunityData, comm,
                 plan: "messages.NeighborExchange | None", wire: dict,
                 packed_aux: "dict | None", fused: bool, overlap: bool,
                 comm_bf16: bool):
        self.cfg, self.admm = cfg, admm
        self.f = gcn.activation_fn(cfg.activation)
        self.dense = not data.compressed
        self.comm_bf16 = comm_bf16
        self.comm = comm
        m = int(data.neighbor_mask.shape[0])
        self.n_shards, self.hosted = comm.n_shards, len(comm.shards)
        self.m, self.k = m, m // self.hosted
        # a rank's objectives are local: the W step psums them
        self.psum = None if self.hosted == self.n_shards else comm.psum
        nbrf = data.neighbor_mask.float()                         # (m, M)
        self.plan = plan
        self.packed_wire = packed_aux is not None and plan is not None
        self.fused = fused and self.packed_wire
        self.overlap = overlap and self.packed_wire
        if self.dense:
            # the kernel takes the blocks and the mask and never reads an
            # absent block; the plain einsum takes the blocks masked once
            # here rather than on every call (x·1 = x, x·0 = 0: same values)
            self.a_row = data.a_blocks
            self.nbr_live = data.neighbor_mask.to(torch.int32).contiguous()
            self.a_masked = self.a_row * nbrf[:, :, None, None]
            self.nbr_wt = nbrf[:, :, None, None]                  # (k,M,1,1)
        else:
            self.ell_rows = data.ell_blocks
            self.nbr_idx = wire["nbr_idx"]
            # the kernels' int32 operands, made once rather than per launch
            self.nbr_idx32 = self.nbr_idx.to(torch.int32).contiguous()
            self.ell_live = (data.ell_mask != 0).to(torch.int32)
            self.ell_f = data.ell_mask.float()
            self.ell_rcnt, self.ell_ncnt = data.row_counts, data.nbr_counts
        if self.packed_wire:
            self.offsets = wire["offsets"]
            self.recv_unpack = wire["recv_unpack"]
        self.packed_aux = packed_aux
        self.denom = data.denom
        self.z0 = self.from_plane(data.z0)
        self.labels = self.from_plane(data.labels)
        self.mask = self.from_plane(data.train_mask)

    # -- layouts -------------------------------------------------------------

    def from_plane(self, p: Tensor) -> Tensor:
        if self.packed_aux is None:
            return p
        flat = _take_fill(p, self.packed_aux["unpack"])
        return flat.reshape((self.m, self.packed_aux["n"])
                            + tuple(p.shape[1:]))

    def to_plane(self, blk: Tensor) -> Tensor:
        if self.packed_aux is None:
            return blk
        flat = blk.reshape((self.m * self.packed_aux["n"],)
                           + tuple(blk.shape[2:]))
        return _take_fill(flat, self.packed_aux["pack"])

    def shard_sum(self, parts_of) -> Tensor:
        """Σ over the hosted shards of ``parts_of(s)``, each shard's value
        from its own lanes only, summed in shard order
        (``messages.fold``): with every shard hosted, the reference's psum
        of a per-shard objective; on a rank its one local part, which the
        W step psums."""
        vals = [parts_of(s) for s in range(self.hosted)]
        out = messages.fold(vals)
        if trace.RECORDER is not None and self.psum is None:
            trace.RECORDER.shard_sum(vals, out)
        return out

    def lanes(self, x: Tensor, s: int) -> Tensor:
        return x if self.hosted == 1 else x[s * self.k:(s + 1) * self.k]

    # -- transport -----------------------------------------------------------

    def gather(self, x: Tensor, batch: _Batch):
        """Every hosted shard's received rows of the stacked blocked
        payload x (m, n_pad, C): the (X, n_pad, C) stack, or on the packed
        wire the receive planes (a sequence of stages with overlap)."""
        feat = tuple(x.shape[1:])
        tr = self.comm
        if self.plan is None:
            return tr.allgather(x, self.comm_bf16)
        if not self.packed_wire:
            buf = tr.exchange(batch.plan, x, self.comm_bf16, batch.tables)
            return buf.reshape((-1,) + feat)
        return tr.exchange_packed(batch.plan, self.to_plane(x),
                                  self.comm_bf16, self.overlap, batch.tables)

    def blocked(self, agg) -> Tensor:
        """The (X, n_pad, C) stack of a ``gather`` result: on the packed
        wire the final receive planes unpacked to the shards' (r_pad,
        n_pad, C) buffers, take-with-fill."""
        if not self.packed_wire:
            return agg
        final = agg[-1] if self.overlap else agg
        return _take_fill(final, self.recv_unpack).reshape(
            (-1, self.packed_aux["n"]) + tuple(final.shape[1:]))

    # -- aggregation ---------------------------------------------------------

    def agg_plane(self, plane: Tensor, mask: Tensor, use_kernel: bool
                  ) -> Tensor:
        """Packed-plane aggregation of every lane in one call."""
        spmm = kops.community_spmm_ell_packed if use_kernel \
            else ref.community_spmm_ell_packed_einsum
        return spmm(self.ell_rows, self.offsets, mask, plane, self.ell_rcnt,
                    self.ell_ncnt)

    def agg_plane_mm(self, plane: Tensor, mask: Tensor, w: Tensor,
                     use_kernel: bool) -> Tensor:
        """(packed aggregate) @ w: the fused kernel, or the reference's
        reassociated plain version A·(Z·W)."""
        if use_kernel:
            return kops.community_spmm_ell_fused(
                self.ell_rows, self.offsets, mask, plane, w, self.ell_rcnt,
                self.ell_ncnt)
        return self.agg_plane(plane @ w, mask, use_kernel=False)

    def by_group(self, agg_fn, agg, batch: _Batch) -> Tensor:
        """``agg_fn(plane, slot mask)`` over the packed wire: one call on
        the final planes, or (overlap) the sum over arrival groups, group g
        read from stage g of the exchange."""
        if not self.overlap:
            return agg_fn(agg, self.ell_live)
        # stage g is read only after group g - 1's call: on the process
        # transport that call runs while round g is still in flight
        acc = agg_fn(agg[0], batch.group_masks[0])
        for g in range(1, len(agg)):
            acc = acc + agg_fn(agg[g], batch.group_masks[g])
        return acc

    def rowagg(self, agg, batch: _Batch, use_kernel: bool) -> Tensor:
        """Σ_{r∈N_m} Ã_{m,r} Z_r per lane: Σ_d Ã[m,d] Z[idx[m,d]] over the
        ELL slots, or over the dense block row masked by N_m."""
        if self.packed_wire:
            return self.by_group(
                lambda plane, msk: self.agg_plane(plane, msk, use_kernel),
                agg, batch)
        if self.dense:
            if use_kernel:
                return kops.community_spmm(self.a_row, agg, self.nbr_live)
            # one product per lane, as ref.community_spmm_ref and the ELL
            # gather-einsum run
            return torch.einsum("kmip,kmpc->kic", self.a_masked,
                                self.nbr_vals(agg).expand(
                                    self.m, *agg.shape))
        if use_kernel:
            return kops.community_spmm_ell(self.ell_rows, self.nbr_idx32,
                                           self.ell_live, agg, self.ell_rcnt,
                                           self.ell_ncnt)
        zg = agg[self.nbr_idx] * self.ell_f[..., None, None]
        return torch.einsum("kdip,kdpc->kic", self.ell_rows.float(),
                            zg.float())

    def agg_mm(self, x, agg, w: Tensor, batch: _Batch, use_kernel: bool
               ) -> Tensor:
        """The aggregation→GEMM of a Z-update site: ``rowagg(x) @ w`` from
        the aggregate ``agg`` already made (computed here when None), or on
        the fused path one fused call per arrival group, which no unfused
        aggregate stands in for."""
        if self.fused:
            return self.by_group(
                lambda plane, msk: self.agg_plane_mm(plane, msk, w,
                                                     use_kernel),
                x, batch)
        if agg is None:
            agg = self.rowagg(x, batch, use_kernel)
        return agg @ w

    def nbr_vals(self, blk: Tensor) -> Tensor:
        """Every lane's neighbour rows of a gathered stack: (M, D, n, C)
        over the ELL slots, or in dense mode the one all-gathered (M, n, C)
        copy as (1, M, n, C), broadcast over the lanes."""
        return blk[None] if self.dense else blk[self.nbr_idx]

    # -- objectives ----------------------------------------------------------

    def w_objectives(self, aggs, zs, u, batch: _Batch) -> list:
        """The W-update objective of each layer (Line 3): the hosted
        shards' local objectives summed, unsampled lanes masked out."""
        admm, f, n_l = self.admm, self.f, self.cfg.num_layers
        sm = None if batch.smask is None else batch.smask[:, None, None]
        lanes = self.lanes
        objs = []
        for l in range(n_l):
            if l < n_l - 1:
                def local_obj(w, agg=aggs[l], z=zs[l]):
                    r = z - f(agg @ w)
                    if sm is not None:
                        r = r * sm
                    rr = r * r
                    return self.shard_sum(
                        lambda s: 0.5 * admm.nu * torch.sum(lanes(rr, s)))
            else:
                def local_obj(w, agg=aggs[l], z=zs[l]):
                    r = z - agg @ w
                    if sm is not None:
                        r = r * sm
                    ur, rr = u * r, r * r
                    return self.shard_sum(
                        lambda s: torch.sum(lanes(ur, s))
                        + 0.5 * admm.rho * torch.sum(lanes(rr, s)))
            objs.append(local_obj)
        return objs

    def z_objective(self, l: int, aggs, zh_in, zh, zs, u, w_l, w_next,
                    batch: _Batch, sdr: "Tensor | None", use_kernel: bool):
        """ψ_{l,m} per lane for hidden layer l (eq. 5/6), with W^{k+1};
        ``sdr`` (M, D) is √ of each stored neighbour's staleness weight
        (minibatching), None for a full batch."""
        admm, f, n_l = self.admm, self.f, self.cfg.num_layers
        # coupling term: Ã_{r,m} = Ã_{m,r}ᵀ (Ã symmetric), so the stored
        # row blocks are consumed transposed — over the max_deg stored
        # neighbours (ELL), or over all M weighted by N_m (dense)
        if self.dense:
            rows, spec, wt = self.a_row, "kmnp,knc->kmpc", self.nbr_wt
        else:
            rows, spec = self.ell_rows.float(), "kdnp,knc->kdpc"
            # staleness: √d_r folded into the coupling weight, so every
            # squared residual carries the full d_r
            wt = (self.ell_f if sdr is None
                  else self.ell_f * sdr)[..., None, None]    # (k, D, 1, 1)
        target1 = f(self.agg_mm(zh_in[l - 1], aggs[l - 1], w_l, batch,
                                use_kernel))               # (k, n, C_l)
        # relay aggregates q_{l,r}: rowagg(zh[l-1]) is aggs[l]
        q_loc = self.agg_mm(zh[l - 1], aggs[l], w_next, batch, use_kernel)
        q_nbr = self.nbr_vals(self.blocked(self.gather(q_loc, batch)))
        z_ref = zs[l - 1]

        def pre_nbr(z):
            delta = (z - z_ref) @ w_next
            return q_nbr + torch.einsum(spec, rows, delta)

        if l + 1 < n_l:
            nxt = self.nbr_vals(self.blocked(zh[l]))

            def obj_lanes(z):
                r1 = z - target1
                v1 = 0.5 * admm.nu * torch.sum(r1 * r1, dim=(1, 2))
                r2 = (nxt - f(pre_nbr(z))) * wt
                v2 = 0.5 * admm.nu * torch.sum(r2 * r2, dim=(1, 2, 3))
                return v1 + v2
        else:
            last = self.nbr_vals(self.blocked(zh[l]))
            uv = self.nbr_vals(self.blocked(self.gather(u, batch)))
            if sdr is not None:
                # the second √d_r: the dual term carries the full d_r
                uv = uv * sdr[..., None, None]

            def obj_lanes(z):
                r1 = z - target1
                v1 = 0.5 * admm.nu * torch.sum(r1 * r1, dim=(1, 2))
                r2 = (last - pre_nbr(z)) * wt
                lin = torch.sum(uv * r2, dim=(1, 2, 3))
                quad = 0.5 * admm.rho * torch.sum(r2 * r2, dim=(1, 2, 3))
                return v1 + lin + quad
        return obj_lanes

    def inputs(self, zs_plane, u_plane, batch: _Batch, use_kernel: bool):
        """Blocked iterates, gathered copies and the layer-input aggregates.

        The reference aggregates the same gathered tensor more than once
        per step (``rowagg(zh[0])`` at repro/core/parallel.py:786, :813 and
        :892, and ``rowagg(zh0)`` at :786 and :811).  Here each layer input
        is aggregated once and reused wherever the reference takes the
        unfused aggregate: the same operands give the same value, so no
        result changes.  The fused sites (``agg_mm`` with ``fused``) make
        their own calls.
        """
        zs = [self.from_plane(z) for z in zs_plane]
        u = self.from_plane(u_plane)
        zh = [self.gather(z, batch) for z in zs]
        zh_in = [self.gather(self.z0, batch)] + zh[:-1]
        aggs = [self.rowagg(x, batch, use_kernel) for x in zh_in]
        return zs, u, zh_in, zh, aggs

    def __call__(self, state: ParallelState, use_kernel: bool,
                 batch: _Batch, sdr: "Tensor | None" = None
                 ) -> ParallelState:
        admm, n_l = self.admm, self.cfg.num_layers
        with trace.span("admm.inputs"):
            zs, u, zh_in, zh, aggs = self.inputs(state.zs, state.u, batch,
                                                 use_kernel)
        keep = None if batch.smask is None else batch.smask > 0

        def sampled(new, old):
            # unsampled lanes keep their iterates bit for bit
            if keep is None:
                return new
            return torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)),
                               new, old)

        # ---- Line 3: W update (layer-parallel, Jacobi over Z^k) ----
        new_ws, new_taus = [], []
        for l, obj in enumerate(self.w_objectives(aggs, zs, u, batch)):
            with trace.span("admm.w_update", l=l):
                w_new, tau = backtracking_step(obj, state.weights[l],
                                               state.taus[l], admm,
                                               psum=self.psum)
            new_ws.append(w_new)
            new_taus.append(tau)

        # ---- Line 4: Z update (community-parallel, reads W^{k+1}, Z^k) ----
        new_zs, new_thetas = [], []
        for l in range(1, n_l):
            with trace.span("admm.z_update", l=l):
                obj_lanes = self.z_objective(l, aggs, zh_in, zh, zs, u,
                                             new_ws[l - 1], new_ws[l], batch,
                                             sdr, use_kernel)
                z_new, theta = backtracking_step_lanes(
                    obj_lanes, zs[l - 1], state.thetas[l - 1], admm)
            new_zs.append(sampled(z_new, zs[l - 1]))
            new_thetas.append(sampled(theta, state.thetas[l - 1]))

        # ---- Z_L: per-community FISTA prox (eq. 7) ----
        with trace.span("admm.z_last"):
            b = self.agg_mm(zh_in[n_l - 1], aggs[n_l - 1], new_ws[-1], batch,
                            use_kernel)
            if use_kernel:
                z_last = kops.fista_lanes(admm, b, u, self.labels, self.mask,
                                          zs[-1], self.denom)
            else:
                trace.count("fista.plain")
                z_last = fista_lanes(admm, b, u, self.labels, self.mask,
                                     zs[-1], self.denom)
        new_zs.append(sampled(z_last, zs[-1]))
        new_thetas.append(state.thetas[-1])

        # ---- Line 5: dual ascent (eq. 3) with updated iterates ----
        with trace.span("admm.u_update"):
            if n_l >= 2:
                pen, agg_pen = self.gather(new_zs[n_l - 2], batch), None
            else:
                pen, agg_pen = zh_in[0], aggs[0]
            b_new = self.agg_mm(pen, agg_pen, new_ws[-1], batch, use_kernel)
            new_u = sampled(u + admm.rho * (new_zs[-1] - b_new), u)

        return ParallelState(tuple(new_ws),
                             tuple(self.to_plane(z) for z in new_zs),
                             self.to_plane(new_u), tuple(new_taus),
                             tuple(new_thetas))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class ParallelADMMTrainer:
    """The paper's 'Parallel ADMM': M community agents over ``n_shards``
    shards (``n_shards`` must divide M; shard s hosts communities [s·k,
    (s+1)·k), k = M / n_shards).

    Without ``mesh`` the shards are logical shards of one device, their
    lanes stacked and every exchange round a row copy (the loopback
    transport); ``device=None`` means ``cuda`` (RuntimeError without one),
    tests pass ``device="cpu"``.  With ``mesh`` (a ``launch.mesh.
    ProcessMesh``, the reference's ``mesh=``) this process is one rank of
    ``mesh.world_size`` shards on ``mesh.device``: it holds only its k
    lanes of Z, U, z0, labels and masks and of the adjacency, exchanges
    rows with the other ranks through ``torch.distributed``
    (``messages.ProcessTransport``) and psums the W objective; W, τ and the
    metrics are replicated.  Every rank builds the same layout and plan
    from the seed.  The metrics and Lagrangian gather the state to rank 0
    once per epoch, and rank 0 alone holds the full adjacency for them.

    The pre-``TrainerConfig`` flag kwargs are accepted with a
    ``DeprecationWarning``, as in the reference."""

    def __init__(self, cfg: gcn.GCNConfig, admm: ADMMConfig, g: graph.Graph,
                 num_parts: int, seed: int = 0,
                 config: TrainerConfig | None = None,
                 part: np.ndarray | None = None,
                 device: "str | torch.device | None" = None,
                 n_shards: int = 1, mesh=None, **legacy_flags):
        if legacy_flags:
            unknown = sorted(set(legacy_flags) - set(_LEGACY_FLAGS))
            if unknown:
                raise TypeError(
                    f"ParallelADMMTrainer got unexpected keyword arguments "
                    f"{unknown}; pass config=TrainerConfig(...)")
            if config is not None:
                raise ValueError(
                    "pass either config=TrainerConfig(...) or the legacy "
                    "flag kwargs, not both")
            warnings.warn(
                "ParallelADMMTrainer flag kwargs are deprecated; pass "
                "config=TrainerConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            config = TrainerConfig(**legacy_flags)
        elif config is None:
            config = TrainerConfig()
        with trace.span("layout"):
            self._build(cfg, admm, g, num_parts, seed, config, part, device,
                        n_shards, mesh)

    def _build(self, cfg: gcn.GCNConfig, admm: ADMMConfig, g: graph.Graph,
               num_parts: int, seed: int, config: TrainerConfig,
               part: "np.ndarray | None", device, n_shards: int,
               mesh) -> None:
        """The constructor's work, in the spans of its parts: the
        community layout, the device data, the first iterates, the plan."""
        self.mesh = mesh
        if mesh is not None:
            if n_shards not in (1, mesh.world_size):
                raise ValueError(f"n_shards={n_shards} disagrees with the "
                                 f"mesh's {mesh.world_size} ranks")
            n_shards, device = mesh.world_size, mesh.device
        self.device = device = resolve_device(device)
        self.config = config
        self.cfg, self.admm, self.graph = cfg, admm, g
        self.compressed = compressed = config.compressed
        self.transport = config.transport
        self.packed = packed = config.packed
        self.overlap, self.fused = config.overlap, config.fused
        self.pad_mode = pad_mode = config.pad_mode
        self.use_kernel = config.use_kernel
        partitioner = config.partitioner
        if part is None:
            partitioner = partitioner or "bfs_kl"
            part = graph.partition_graph(g.num_nodes, g.edges, num_parts,
                                         seed=seed, method=partitioner)
        else:
            partitioner = partitioner or "precomputed"
        self.partitioner = partitioner
        with trace.span("layout.partition_quality"):
            self.partition_stats = graph.partition_quality(
                g.num_nodes, g.edges, part, num_parts)
        with trace.span("layout.community"):
            self.layout = lay = graph.build_community_layout(
                g.num_nodes, g.edges, part, compressed=compressed,
                pad_mode=pad_mode)
        m = int(np.asarray(lay.neighbor_mask).shape[0])
        if n_shards < 1 or m % n_shards:
            raise ValueError(f"n_shards={n_shards} must divide the {m} "
                             f"communities")
        self.n_shards = n_shards
        k = m // n_shards
        if mesh is None:
            self.comm = messages.Loopback(n_shards)
            self.rank, lanes = 0, slice(0, m)
        else:
            self.comm = messages.ProcessTransport(mesh)
            self.rank, lanes = mesh.rank, slice(mesh.rank * k,
                                                (mesh.rank + 1) * k)
        self._lanes = lanes

        with trace.span("layout.device_layout"):
            self.packed_layout = lay.device_layout(n_shards) if packed \
                else None
        # the full data serves the step on the loopback and the metrics on
        # rank 0; any other rank holds its lanes' only
        data_kw = dict(compressed=compressed,
                       adjacency_bf16=config.adjacency_bf16,
                       device_layout=self.packed_layout, device=device)
        with trace.span("layout.community_data"):
            if self.rank == 0:
                self._full_data = community_data(g, lay, **data_kw)
                self.data = self._full_data if mesh is None \
                    else lane_data(self._full_data, lanes)
            else:
                self._full_data = None
                self.data = community_data(g, lay, lanes=lanes, **data_kw)

        with trace.span("layout.first_iterates"):
            self.state = self._first_state(cfg, admm, g, seed, m)

        with trace.span("layout.plan"):
            self._plan_and_tables(lay, m, k, lanes)

    def _first_state(self, cfg: gcn.GCNConfig, admm: ADMMConfig,
                     g: graph.Graph, seed: int, m: int) -> ParallelState:
        """The first iterates, from the same forward pass as the serial
        trainer (dense Ã on the device), in this process's layout."""
        device = self.device
        gen = torch.Generator().manual_seed(seed)
        ws = gcn.init_weights(cfg, gen, device)
        a_full = torch.as_tensor(
            graph.normalized_adjacency(g.num_nodes, g.edges), device=device)
        zs_full = gcn.forward(cfg, a_full,
                              torch.as_tensor(g.features, device=device), ws)
        del a_full
        zs = tuple(self._to_state(z.cpu().numpy()) for z in zs_full)
        del zs_full
        u = torch.zeros_like(zs[-1])
        taus = tuple(torch.tensor(admm.tau_init, dtype=torch.float32,
                                  device=device) for _ in ws)
        thetas = tuple(torch.full((m,), admm.tau_init, dtype=torch.float32,
                                  device=device) for _ in zs)
        return self.shard_state(ParallelState(tuple(ws), zs, u, taus,
                                              thetas))

    def _plan_and_tables(self, lay: graph.CommunityLayout, m: int, k: int,
                         lanes: slice) -> None:
        """The exchange plan, the step program's index tables, the
        minibatch sampler, ``comm_stats`` and the metrics' views."""
        cfg, admm, config, mesh = self.cfg, self.admm, self.config, self.mesh
        device, packed, compressed = self.device, self.packed, \
            self.compressed
        n_shards, pad_mode, hosted = self.n_shards, self.pad_mode, \
            self.comm.shards

        # the exchange plan: the p2p transport's accounting at any shard
        # count; the step runs it only across shards (with one shard the
        # reference drops it: nothing crosses a wire)
        self._plan = None
        if self.transport == "p2p":
            self._plan = messages.build_neighbor_exchange(
                lay.neighbor_mask, n_shards, lay.n_pad,
                sizes=lay.sizes if pad_mode == "bucketed" else None,
                row_counts=lay.eff_row_counts() if packed else None)
        body_plan = self._plan if n_shards > 1 else None
        overlap_on = bool(config.overlap and body_plan is not None)

        def dev(x, dtype=torch.long):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        # the hosted shards' lanes, in the shift of their blocked / plane
        # rows: on the loopback shard s's at s · rows, on a rank at 0
        lane_shard = (np.arange(m) // k - self.rank)[lanes, None]
        wire, self._slots = {}, None
        if compressed:
            csr = lay.compress()
            if body_plan is None:
                # all-gather: global ids into the one gathered copy
                wire["nbr_idx"] = dev(csr.ell_indices[lanes])
            else:
                self._slots = body_plan.localize_indices(csr.ell_indices,
                                                         csr.ell_mask)
                wire["nbr_idx"] = dev(self._slots[lanes]
                                      + lane_shard * body_plan.r_pad)
        packed_aux = None
        if packed:
            dl = self.packed_layout
            if mesh is None:
                unpack, pack = dl.global_unpack_rows(), dl.global_pack_rows()
            else:
                unpack, pack = dl.unpack_rows[self.rank], \
                    dl.pack_rows[self.rank]
            packed_aux = {"n": int(dl.n_pad), "unpack": dev(unpack),
                          "pack": dev(pack)}
            if body_plan is not None:
                # the hosted shards' receive planes end to end: shard s's
                # offsets shifted by s · recv_plane_rows, one launch for
                # all their lanes
                rpr = body_plan.recv_plane_rows
                off = body_plan.localized_offsets(
                    csr.ell_indices, csr.ell_mask)[lanes] + lane_shard * rpr
                _, nbrs = csr.ell_row_counts()
                community_spmm.check_plane_offsets(
                    off, csr.ell_mask[lanes], nbrs[lanes], len(hosted) * rpr)
                wire["offsets"] = dev(off, torch.int32).contiguous()
                ru = np.asarray(body_plan.recv_unpack_rows,
                                dtype=np.int64)[list(hosted)]
                wire["recv_unpack"] = dev(np.where(
                    ru < rpr, np.arange(len(hosted))[:, None] * rpr + ru,
                    len(hosted) * rpr).reshape(-1))
        self._body = _Body(cfg, admm, self.data, self.comm, body_plan,
                           wire, packed_aux, config.fused, overlap_on,
                           config.comm_bf16)
        self._body_plan, self._overlap_on = body_plan, overlap_on

        # minibatching: one _Batch per distinct shard batch
        self._batches: dict = {}
        self._sampler = None
        self._round = 0
        if config.batch_fraction is None:
            self._full = self._make_batch(None)
            self._active_plan = self._plan
        else:
            # shard batch weights = Σ bucket rows hosted, so the greedy
            # balance targets resident/wire work, not shard count alone
            rc_shard = np.asarray(lay.eff_row_counts(), dtype=np.float64
                                  ).reshape(n_shards, k).sum(axis=1)
            self._sampler = partition.CommunityBatchSampler(
                n_shards, config.batch_fraction, seed=config.sample_seed,
                weights=rc_shard)
            self._mb_nbr = np.asarray(lay.compress().ell_indices)  # (M, D)
            self._ages = np.zeros(m, dtype=np.int64)
            plan0 = self._batch_for(self._current_shards()).plan
            self._active_plan = plan0 if plan0 is not None else self._plan
        self.comm_stats = self._comm_stats()

        # metrics/Lagrangian run on the blocked (M, n_pad, ...) view of
        # the full state (gathered to rank 0 under a mesh); in packed mode
        # the state planes are rebuilt through the device layout's global
        # row table (take-with-fill, lossless under the
        # zero-outside-counts contract)
        data = self._full_data
        if data is None:
            return
        if packed:
            self._gup = dev(self.packed_layout.global_unpack_rows())
        self._z0_blk = self._unfold(data.z0)
        self._labels_blk = self._unfold(data.labels)
        self._train_blk = self._unfold(data.train_mask)
        self._test_blk = self._unfold(data.test_mask)
        self._row_mask = data.row_mask[..., None]
        if compressed:
            self._ell_idx32 = data.ell_indices.to(torch.int32).contiguous()
            self._ell_live = self._body.ell_live if mesh is None else \
                (data.ell_mask != 0).to(torch.int32)
        else:
            self._a_masked = self._body.a_masked if mesh is None else \
                data.a_blocks * data.neighbor_mask.float()[:, :, None, None]

    # -- state layout ------------------------------------------------------

    def _to_state(self, x: np.ndarray) -> Tensor:
        """(N, C) node rows -> the trainer's resident state layout."""
        blk = self.layout.pack(x)
        if self.packed:
            blk = self.packed_layout.pack_state(blk)
        return torch.as_tensor(blk, device=self.device)

    def shard_state(self, state: ParallelState) -> ParallelState:
        """This process's part of a full state: under a mesh its lanes of
        Z, U and θ (of a packed plane its plane's rows), W and τ as they
        are; the full state itself on the loopback."""
        if self.mesh is None:
            return state
        lanes = self._lanes
        rows = lanes
        if self.packed:
            pr = self.packed_layout.plane_rows
            rows = slice(self.rank * pr, (self.rank + 1) * pr)
        return ParallelState(
            state.weights, tuple(z[rows].clone() for z in state.zs),
            state.u[rows].clone(), state.taus,
            tuple(t[lanes].clone() for t in state.thetas))

    def full_state(self) -> "ParallelState | None":
        """The full state: on the loopback the state; under a mesh every
        rank's part gathered to rank 0 (None on the other ranks)."""
        if self.mesh is None:
            return self.state
        from repro_torch.convert import gather_state
        return gather_state(self.mesh, self.state)

    def _unfold(self, p: Tensor) -> Tensor:
        if not self.packed:
            return p
        m, n = self.layout.num_parts, self.layout.n_pad
        return _take_fill(p, self._gup).reshape((m, n) + tuple(p.shape[1:]))

    # -- minibatching --------------------------------------------------------

    def _make_batch(self, sampled: "frozenset | None") -> _Batch:
        """The step program's per-batch operands: ``sampled`` shard ids, or
        None for the full batch.  A sampled batch runs the plan restricted
        to the pairs into sampled shards (``messages.restrict_exchange``)
        and masks the unsampled lanes; with overlap, each ELL slot's
        arrival group comes from the rounds of the plan this batch runs
        (0 = resident, g = delivered by round g - 1; a slot the restricted
        plan never delivers falls in group 0 and reaches only unsampled
        lanes)."""
        m, s_n = self.layout.num_parts, self.n_shards
        plan, smask, tables = self._body_plan, None, None
        if sampled is not None:
            if plan is not None:
                plan = messages.restrict_exchange(plan, sampled)
            lanes = np.zeros((s_n, m // s_n), dtype=np.float32)
            lanes[sorted(sampled)] = 1.0
            smask = torch.as_tensor(lanes.reshape(m)[self._lanes],
                                    device=self.device)
        groups = None
        if self._overlap_on:
            csr = self.layout.compress()
            live = np.asarray(csr.ell_mask) != 0
            arr = messages.arrival_rounds(plan)
            shard = (np.arange(m) // (m // s_n))[:, None]
            grp = np.where(live, arr[shard, self._slots] + 1, 0)
            groups = tuple(
                torch.as_tensor((live & (grp == gi)).astype(np.int32)
                                [self._lanes], device=self.device)
                for gi in range(plan.num_rounds + 1))
        if plan is not None:
            tables = self.comm.tables(plan, self.device)
        return _Batch(plan, tables, groups, smask)

    def _batch_for(self, shards: frozenset) -> _Batch:
        batch = self._batches.get(shards)
        if batch is None:
            batch = self._batches[shards] = self._make_batch(shards)
        return batch

    def _current_shards(self) -> frozenset:
        return frozenset(self._sampler.batch(self._round))

    def _nbr_decay(self) -> np.ndarray:
        """Per-ELL-slot staleness weight d_r = stale_decay**age_r, looked
        up by the global neighbour community id, (M, max_deg) f32."""
        d = stale_weights(self._ages, self.config.stale_decay)
        return d[self._mb_nbr]

    def _current_batch(self) -> tuple[_Batch, "Tensor | None"]:
        """This round's batch and √ of its staleness weights."""
        if self._sampler is None:
            return self._full, None
        decay = torch.as_tensor(self._nbr_decay()[self._lanes],
                                device=self.device)
        return self._batch_for(self._current_shards()), torch.sqrt(decay)

    # -- accounting ----------------------------------------------------------

    def _comm_stats(self) -> dict:
        """The reference's ``comm_stats``, key for key: gathered and wired
        bytes, padding, adjacency and resident-state accounting, the
        exchange plan's pricing (``overlap`` on the port's H100 model,
        ``messages.PEAK_FLOPS`` / ``LINK_BW``) and the minibatch schedule."""
        cfg, lay, config = self.cfg, self.layout, self.config
        item = 2 if config.comm_bf16 else 4
        dims = list(cfg.layer_dims)
        gathered_cs = gathered_widths(cfg)
        cs = messages.gather_bytes(lay.neighbor_mask, lay.n_pad, gathered_cs,
                                   itemsize=item)
        cs["transport"] = self.transport
        cs["pad_mode"] = self.pad_mode
        # pad rows drop out of the FLOPs only in the guarded ELL kernel
        kernel_ragged = self.compressed and self.use_kernel
        wire_ragged = self.transport == "p2p"
        ps_flops = messages.pad_stats(
            lay.neighbor_mask, lay.sizes,
            lay.row_counts if kernel_ragged else None, lay.n_pad,
            gathered_cs, itemsize=item)
        ps_wire = messages.pad_stats(
            lay.neighbor_mask, lay.sizes,
            lay.row_counts if wire_ragged else None, lay.n_pad,
            gathered_cs, itemsize=item)
        cs.update(ps_wire)
        cs.update({k: ps_flops[k] for k in
                   ("pad_flops", "agg_flops", "pad_flop_frac")})
        cs["pad_guards"] = {"kernel": kernel_ragged, "wire": wire_ragged}
        cs["partitioner"] = self.partitioner
        cs["partition"] = dict(self.partition_stats)
        if self._plan is not None:
            # scheduled p2p wire volume, tied to the mask-derived stats by
            # the transport invariant: wire == true rows + round padding
            cs.update(messages.exchange_bytes(self._plan, gathered_cs,
                                              itemsize=item))
            messages.verify_transport_bytes(cs)
        else:
            # an all-gather moves every row to every shard
            cs["wire_bytes"] = cs["full_bytes"]
        cs["adjacency"] = messages.adjacency_bytes(
            lay.neighbor_mask, lay.n_pad,
            itemsize=2 if config.adjacency_bf16 else 4)
        # every shard's lanes: a rank's share times the shards
        cs["adjacency"]["resident_bytes"] = int(
            self.data.adjacency_nbytes * self.n_shards
            // len(self.comm.shards))
        z_cols = sum(dims[1:])
        state_cols = dims[0] + z_cols + dims[-1]
        rc_eff = np.asarray(lay.eff_row_counts(), dtype=np.int64)
        strided_rows = lay.num_parts * lay.n_pad
        rows = self.packed_layout.total_rows if self.packed \
            else strided_rows
        cs["state"] = {
            "packed": self.packed,
            "itemsize": 4,
            "rows": int(rows),
            "strided_rows": int(strided_rows),
            "bucket_rows": int(rc_eff.sum()),
            "node_rows": int(np.asarray(lay.sizes).sum()),
            "z_bytes": int(rows * z_cols * 4),
            "z_strided_bytes": int(strided_rows * z_cols * 4),
            "resident_bytes": int(rows * (state_cols + 3) * 4),
            "strided_equiv_bytes": int(strided_rows * (state_cols + 3) * 4),
        }
        if self._plan is not None:
            # the overlap pricing of the plan the step runs (the restricted
            # one under minibatching; ``step`` re-prices it)
            def pricing(plan):
                return messages.overlap_stats(
                    plan, lay.neighbor_mask, gathered_cs, itemsize=item,
                    enabled=self._overlap_on)
            self._overlap_pricing = pricing
            cs["overlap"] = pricing(self._active_plan)
        if self._sampler is None:
            cs["minibatch"] = {"enabled": False}
            return cs
        # sampled-round accounting over the first sampler cycle, each
        # batch's restricted schedule priced like the full plan
        s_n = self.n_shards
        rc_sh = rc_eff.reshape(s_n, lay.num_parts // s_n)
        cyc = self._sampler.cycle(0)
        wires, rows_b = [], []
        for b in cyc:
            sub = self._plan if len(b) == s_n else \
                messages.restrict_exchange(self._plan, frozenset(b))
            wires.append(int(messages.exchange_bytes(
                sub, gathered_cs, itemsize=item)["wire_bytes"]))
            rows_b.append(int(rc_sh[list(b)].sum()))
        cs["minibatch"] = {
            "enabled": True,
            "batch_fraction": float(config.batch_fraction),
            "stale_decay": float(config.stale_decay),
            "sample_seed": int(config.sample_seed),
            "num_batches": int(self._sampler.num_batches),
            "schedule": [list(b) for b in cyc],
            "sampled_wire_bytes": wires[0],
            "mean_sampled_wire_bytes": float(np.mean(wires)),
            "full_wire_bytes": int(cs["wire_bytes"]),
            "sampled_state_rows": rows_b[0],
            "mean_sampled_state_rows": float(np.mean(rows_b)),
            "full_state_rows": int(rc_sh.sum()),
        }
        return cs

    # -- the step ------------------------------------------------------------

    @torch.no_grad()
    def next_state(self, state: "ParallelState | None" = None,
                   use_kernel: "bool | None" = None) -> ParallelState:
        """One ADMM iteration from ``state`` (default: the current state)
        on this round's batch, without changing the trainer; ``use_kernel``
        overrides the configured aggregation path."""
        state = self.state if state is None else state
        use_kernel = self.use_kernel if use_kernel is None else use_kernel
        batch, sdr = self._current_batch()
        out = self._body(state, use_kernel, batch, sdr)
        self.comm.flush()
        return out

    def step(self) -> None:
        """One ADMM iteration.  Under a mesh ``comm_stats`` then holds the
        step's measured wire: ``sent_bytes`` (every rank's),
        ``rank_sent_bytes`` (by rank), and this rank's ``transport_s`` and
        ``staging_s`` (host seconds in the transport, and of them in its
        host staging copies)."""
        with trace.span(trace.STEP):
            if self.mesh is None:
                self._advance()
            else:
                self._advance_measured()

    def _advance_measured(self) -> None:
        t = self.comm
        sent, secs, staged = t.sent_bytes, t.time_s, t.staging_s
        self._advance()
        mine = torch.tensor([t.sent_bytes - sent], dtype=torch.int64,
                            device=self.device)
        parts = messages.gather_parts(self.mesh, mine)
        with trace.marked("wire-accounting", reads=len(parts)):
            per_rank = [int(x) for x in parts]
        self.comm_stats.update(sent_bytes=sum(per_rank),
                               rank_sent_bytes=per_rank,
                               transport_s=t.time_s - secs,
                               staging_s=t.staging_s - staged)

    def _advance(self) -> None:
        if self._sampler is None:
            self.state = self.next_state()
            return
        shards = self._current_shards()
        plan = self._batch_for(shards).plan
        self._active_plan = plan if plan is not None else self._plan
        if "overlap" in self.comm_stats:
            # keep the overlap pricing tied to the plan this round runs
            self.comm_stats["overlap"] = self._overlap_pricing(
                self._active_plan)
        self.state = self.next_state()
        # ages advance after the round: a community sampled this round
        # ends it fresh (age 0), everyone else's consensus terms are one
        # round staler
        self._ages += 1
        k = self.layout.num_parts // self.n_shards
        for s in shards:
            self._ages[s * k:(s + 1) * k] = 0
        self._round += 1
        mb = self.comm_stats["minibatch"]
        mb["rounds"] = self._round
        mb["last_batch"] = sorted(shards)
        mb["max_age"] = int(self._ages.max())

    def objectives(self, use_kernel: "bool | None" = None) -> dict:
        """Branch-free diagnostics at the current state: the values and
        gradients that decide the first backtracking test of each search.

        ``w``: per layer, (φ_l(W_l), ∇φ_l) of the W update.  ``z``: per
        hidden layer l, (ψ_l per lane, ∇ψ_l) at Z_l, evaluated with the
        current weights standing in for W^{k+1}.  ``use_kernel`` picks the
        aggregation path (default: the trainer's).
        """
        use_kernel = self.use_kernel if use_kernel is None else use_kernel
        body, st = self._body, self.state
        batch, sdr = self._current_batch()
        with torch.no_grad():
            zs, u, zh_in, zh, aggs = body.inputs(st.zs, st.u, batch,
                                                 use_kernel)
        self.comm.flush()
        out = {"w": [], "z": []}
        for l, obj in enumerate(body.w_objectives(aggs, zs, u, batch)):
            val, grad = value_and_grad(obj, st.weights[l])
            if body.psum is not None:
                val, grad = body.psum(val), body.psum(grad)
            out["w"].append((val, grad))
        for l in range(1, self.cfg.num_layers):
            with torch.no_grad():
                obj = body.z_objective(l, aggs, zh_in, zh, zs, u,
                                       st.weights[l - 1], st.weights[l],
                                       batch, sdr, use_kernel)
            out["z"].append(value_and_grad(obj, zs[l - 1]))
        return out

    # -- metrics -------------------------------------------------------------

    def _agg_full(self, z: Tensor) -> Tensor:
        """Full-M aggregation of the metrics and the Lagrangian over the
        global ELL indices at every shard count, whatever ``use_kernel``
        says, as in the reference (repro/core/parallel.py:1317-1334): the
        ELL kernel on the card in compressed mode, the masked einsum in
        dense mode."""
        if not self.compressed:
            return torch.einsum("kmip,kmpc->kic", self._a_masked,
                                z.expand(len(self._a_masked), *z.shape))
        d = self._full_data
        return kops.community_spmm_ell(d.ell_blocks, self._ell_idx32,
                                       self._ell_live, z, d.row_counts,
                                       d.nbr_counts)

    def _forward_blocked(self, weights) -> Tensor:
        """Community-blocked forward pass — logits (M, n_pad, C_L)."""
        f = gcn.activation_fn(self.cfg.activation)
        z = self._z0_blk
        for l, w in enumerate(weights):
            z = self._agg_full(z) @ w
            if l < self.cfg.num_layers - 1:
                z = f(z)
        return z

    @torch.no_grad()
    def _metrics(self, state: ParallelState):
        """(train accuracy, test accuracy, ‖Z_L − Ã Z_{L-1} W_L‖)."""
        logits = self._forward_blocked(state.weights)
        z_pen = self._unfold(state.zs[-2]) if self.cfg.num_layers >= 2 \
            else self._z0_blk
        res = (self._unfold(state.zs[-1])
               - self._agg_full(z_pen) @ state.weights[-1]) * self._row_mask
        return (gcn.accuracy(logits, self._labels_blk, self._train_blk),
                gcn.accuracy(logits, self._labels_blk, self._test_blk),
                torch.linalg.norm(res))

    @torch.no_grad()
    def _lagrangian(self, state: ParallelState) -> Tensor:
        """ℒ_ρ(W, Z, U) — eq. (1) on the blocked iterates, every residual
        masked down to the true community rows."""
        f = gcn.activation_fn(self.cfg.activation)
        admm, rm = self.admm, self._row_mask
        ws = state.weights
        zs = [self._unfold(z) for z in state.zs]
        u = self._unfold(state.u)
        logp = torch.log_softmax(zs[-1], dim=-1)
        nll = -torch.gather(logp, -1, self._labels_blk.long()[..., None])
        val = torch.sum(nll[..., 0] * self._train_blk) / \
            self._full_data.denom
        z_prev = self._z0_blk
        for l in range(self.cfg.num_layers - 1):
            r = (zs[l] - f(self._agg_full(z_prev) @ ws[l])) * rm
            val = val + 0.5 * admm.nu * torch.sum(r * r)
            z_prev = zs[l]
        r = (zs[-1] - self._agg_full(z_prev) @ ws[-1]) * rm
        return val + torch.sum(u * rm * r) + 0.5 * admm.rho * torch.sum(r * r)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def epoch_metrics(self) -> list[float]:
        """[train accuracy, test accuracy, Lagrangian, residual] of the
        current state; under a mesh rank 0's, from the state gathered
        there, on every rank."""
        full = self.full_state()
        vals = None
        if full is not None:
            tr, te, res = self._metrics(full)
            vals = [float(tr), float(te), float(self._lagrangian(full)),
                    float(res)]
        if self.mesh is not None:
            import torch.distributed as dist
            box = [vals]
            dist.broadcast_object_list(box, src=0, group=self.mesh.group)
            vals = box[0]
        return vals

    def train(self, epochs: int, verbose: bool = False) -> TrainLog:
        """``epochs`` steps, each timed on the host clock (step time) and
        followed by the metrics; under a mesh every rank returns rank 0's
        log, with its own step times."""
        log = TrainLog()
        for epoch in range(epochs):
            self._sync()
            t0 = time.perf_counter()
            self.step()
            self._sync()
            dt = time.perf_counter() - t0
            tr, te, lag, res = self.epoch_metrics()
            log.epoch.append(epoch)
            log.train_acc.append(tr)
            log.test_acc.append(te)
            log.lagrangian.append(lag)
            log.residual.append(res)
            log.epoch_time_s.append(dt)
            if verbose:
                print(f"[parallel-admm] epoch {epoch:3d} train {tr:.3f} "
                      f"test {te:.3f} lagr {lag:.4f} res {res:.2e} "
                      f"({dt*1e3:.1f} ms)")
        return log
