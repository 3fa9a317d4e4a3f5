"""Parallel (community-distributed) ADMM trainer — Algorithm 1 on one device.

The port's counterpart of ``repro.core.parallel`` for one shard: one device
hosts all ``k = M`` community agents as lanes.  One ADMM iteration:

  * W update — layer-parallel (Jacobi): every layer's objective is the sum
    over lanes, and the backtracking test runs on that global objective
    (``subproblems.backtracking_step``: the reference's psum over shards is
    the identity on one shard).
  * Z update — community-parallel: each lane solves its ψ_{l,m} (eq. 5/6)
    with its own backtracking θ_{l,m} (``backtracking_step_lanes``); Z_L by
    per-lane FISTA (eq. 7, ``fista_lanes``).
  * U update — local dual ascent (eq. 3).

Every aggregation Σ_{r∈N_m} Ã_{m,r} Z_r runs over one of two adjacency
representations, either through a hand-written CUDA kernel
(``use_kernel=True``) or through a plain einsum:

  * dense (``compressed=False``, the default): the (M, M, n_pad, n_pad)
    block tensor, through ``kernels.ops.community_spmm`` (absent blocks
    skipped by the per-lane neighbour mask) or the masked einsum;
  * block-compressed ELL (``compressed=True``): through
    ``kernels.ops.community_spmm_ell`` or the gather-einsum, with f32 or
    (``adjacency_bf16``) bf16 blocks accumulated in f32.

With one shard nothing crosses a wire: the reference drops the packed wire
and the p2p plan from its one-shard program (repro/core/parallel.py:
1023-1028), and its all-gather at one shard is the lanes themselves masked
by the union of their neighbourhoods.  So ``transport`` changes nothing
here, ``fused`` and ``overlap`` are inert, and ``packed=True`` only changes
how the state is stored (Σ-bucket-rows planes, unpacked to blocked views
with take-with-fill tables inside the step).

Each ``lax.while_loop`` of the reference is a host loop with the same
acceptance test; each ``lax.scan`` a Python loop.  Gradients come from
autograd; the aggregates reach every objective as constants, so no
gradient flows through the kernel.

Not in this slice (they raise ``NotImplementedError``): ``batch_fraction``
and ``comm_bf16``; more than one shard has no entry point yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gcn, graph, messages
from repro_torch.core.serial import TrainLog
from repro_torch.core.subproblems import (ADMMConfig, backtracking_step,
                                          value_and_grad)
from repro_torch.kernels import community_spmm
from repro_torch.kernels import ops as kops
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


def community_data(g: graph.Graph, layout: graph.CommunityLayout,
                   compressed: bool = False,
                   adjacency_bf16: bool = False,
                   device_layout: "graph.PackedDeviceLayout | None" = None,
                   device: "str | torch.device | None" = None
                   ) -> CommunityData:
    if adjacency_bf16 and not compressed:
        raise ValueError("adjacency_bf16=True requires compressed=True — "
                         "only the ELL block store has a bf16 path")
    if device_layout is not None and not compressed:
        raise ValueError("packed device state requires compressed=True — "
                         "the dense block tensor keeps the n_pad stride")
    device = resolve_device(device)

    def tens(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    if compressed:
        csr = layout.compress()
        rows, nbrs = csr.ell_row_counts()
        # the CUDA kernel reads live indices unchecked: check them once here
        community_spmm.check_indices(torch.as_tensor(csr.ell_indices),
                                     torch.as_tensor(csr.ell_mask),
                                     csr.num_parts)
        block_dt = torch.bfloat16 if adjacency_bf16 else torch.float32
        adj = {"a_blocks": None,
               "ell_blocks": tens(csr.ell_blocks).to(block_dt),
               "ell_indices": tens(csr.ell_indices),
               "ell_mask": tens(csr.ell_mask),
               "row_counts": tens(rows),
               "nbr_counts": tens(nbrs)}
    else:
        adj = {"a_blocks": tens(layout.a_blocks)}
    if device_layout is not None:
        # Σ-bucket-rows planes: pad rows outside the bucket counts are
        # zero by the layout contract, so pack is lossless
        def dev(x):
            return tens(device_layout.pack_state(layout.pack(x)))
    else:
        def dev(x):
            return tens(layout.pack(x))
    return CommunityData(
        z0=dev(g.features),
        labels=dev(g.labels.astype(np.int32)),
        train_mask=dev(g.train_mask.astype(np.float32)),
        test_mask=dev(g.test_mask.astype(np.float32)),
        neighbor_mask=tens(layout.neighbor_mask),
        denom=torch.tensor(float(g.train_mask.sum()), dtype=torch.float32,
                           device=device),
        row_mask=tens(layout.node_mask.astype(np.float32)),
        packed_layout=device_layout,
        **adj,
    )


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


def _unsupported(config: TrainerConfig) -> "str | None":
    """Why this slice cannot run ``config``, naming the ROADMAP item (queue
    A) that brings it; None when it can."""
    if config.batch_fraction is not None:
        return ("batch_fraction (community minibatching) is not ported yet: "
                "ROADMAP queue A, 'Multi-shard transport'")
    if config.comm_bf16:
        return ("comm_bf16 (the bf16 wire) is not ported yet: ROADMAP queue "
                "A, 'Multi-shard transport'")
    return None


# ---------------------------------------------------------------------------
# backtracking primitives
# ---------------------------------------------------------------------------

def _lane_search(accepted, step0: Tensor, admm: ADMMConfig) -> Tensor:
    """Per-lane doubling until every lane accepts (frozen lanes stop)."""
    step = step0
    done = accepted(step)
    for _ in range(admm.max_backtracks):
        if bool(done.all()):
            break
        step = torch.where(done, step, step * admm.backtrack_growth)
        done = done | accepted(step)
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
    each lane with its own Lipschitz backtracking."""
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
# one ADMM iteration (k = M lanes on one device)
# ---------------------------------------------------------------------------

def _take_fill(x: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``x`` at ``idx``; an index past the end gives a zero row
    (``jnp.take(..., mode="fill", fill_value=0)``)."""
    valid = idx < x.shape[0]
    rows = x[torch.where(valid, idx, 0)]
    return torch.where(valid.view((-1,) + (1,) * (x.dim() - 1)), rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _Body:
    """The per-step program of the reference's ``_iteration_body`` at one
    shard, with its static operands bound: dense or compressed adjacency.

    ``gather`` is the reference's all-gather at one shard: the lanes are
    already every community, masked by the union of the lanes'
    neighbourhoods (all ones here — every lane neighbours itself).
    """

    def __init__(self, cfg: gcn.GCNConfig, admm: ADMMConfig,
                 data: CommunityData, packed_aux: "dict | None"):
        self.cfg, self.admm = cfg, admm
        self.f = gcn.activation_fn(cfg.activation)
        self.dense = not data.compressed
        nbrf = data.neighbor_mask.float()                         # (M, M)
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
            self.ell_idx = data.ell_indices.long()
            # the kernel's int32 operands, made once rather than per launch
            self.ell_idx32 = data.ell_indices.to(torch.int32).contiguous()
            self.ell_live = (data.ell_mask != 0).to(torch.int32)
            self.ell_f = data.ell_mask.float()
            self.ell_rcnt, self.ell_ncnt = data.row_counts, data.nbr_counts
        self.shard_nbr = nbrf.amax(dim=0)                         # (M,)
        self.packed_aux = packed_aux
        self.denom = data.denom
        self.z0 = self.from_plane(data.z0)
        self.labels = self.from_plane(data.labels)
        self.mask = self.from_plane(data.train_mask)

    def from_plane(self, p: Tensor) -> Tensor:
        if self.packed_aux is None:
            return p
        k, n = self.packed_aux["k"], self.packed_aux["n"]
        flat = _take_fill(p, self.packed_aux["unpack"])
        return flat.reshape((k, n) + tuple(p.shape[1:]))

    def to_plane(self, blk: Tensor) -> Tensor:
        if self.packed_aux is None:
            return blk
        k, n = self.packed_aux["k"], self.packed_aux["n"]
        flat = blk.reshape((k * n,) + tuple(blk.shape[2:]))
        return _take_fill(flat, self.packed_aux["pack"])

    def rowagg(self, zh: Tensor, use_kernel: bool) -> Tensor:
        """Σ_{r∈N_m} Ã_{m,r} Z_r per lane: Σ_d Ã[m,d] Z[idx[m,d]] over the
        ELL slots, or over the dense block row masked by N_m."""
        if self.dense:
            if use_kernel:
                return kops.community_spmm(self.a_row, zh, self.nbr_live)
            # one product per lane, as ref.community_spmm_ref and the ELL
            # gather-einsum run
            return torch.einsum("kmip,kmpc->kic", self.a_masked,
                                zh.expand(len(self.a_masked), *zh.shape))
        if use_kernel:
            return kops.community_spmm_ell(self.ell_rows, self.ell_idx32,
                                           self.ell_live, zh, self.ell_rcnt,
                                           self.ell_ncnt)
        zg = zh[self.ell_idx] * self.ell_f[..., None, None]
        return torch.einsum("kdip,kdpc->kic", self.ell_rows.float(),
                            zg.float())

    def gather(self, x_loc: Tensor) -> Tensor:
        return x_loc * self.shard_nbr[:, None, None].to(x_loc.dtype)

    def w_objectives(self, aggs, zs, u) -> list:
        """The W-update objective of each layer (Line 3)."""
        admm, f, n_l = self.admm, self.f, self.cfg.num_layers
        objs = []
        for l in range(n_l):
            if l < n_l - 1:
                def local_obj(w, agg=aggs[l], z=zs[l]):
                    r = z - f(agg @ w)
                    return 0.5 * admm.nu * torch.sum(r * r)
            else:
                def local_obj(w, agg=aggs[l], z=zs[l]):
                    r = z - agg @ w
                    return torch.sum(u * r) + \
                        0.5 * admm.rho * torch.sum(r * r)
            objs.append(local_obj)
        return objs

    def z_objective(self, l: int, aggs, zh, zs, u, w_l, w_next):
        """ψ_{l,m} per lane for hidden layer l (eq. 5/6), with W^{k+1}."""
        admm, f, n_l = self.admm, self.f, self.cfg.num_layers
        # coupling term: Ã_{r,m} = Ã_{m,r}ᵀ (Ã symmetric), so the stored
        # row blocks are consumed transposed — over the max_deg stored
        # neighbours (ELL), or over all M weighted by N_m (dense)
        if self.dense:
            rows, spec, wt = self.a_row, "kmnp,knc->kmpc", self.nbr_wt

            def nbr_vals(x_all):              # (M, n, C) -> (1, M, n, C)
                return x_all[None]
        else:
            rows, spec = self.ell_rows.float(), "kdnp,knc->kdpc"
            wt = self.ell_f[..., None, None]                 # (k, D, 1, 1)

            def nbr_vals(x_all):              # (M, n, C) -> (k, D, n, C)
                return x_all[self.ell_idx]
        target1 = f(aggs[l - 1] @ w_l)                     # (k, n, C_l)
        # relay aggregates q_{l,r}: rowagg(zh[l-1]) is aggs[l]
        q_nbr = nbr_vals(self.gather(aggs[l] @ w_next))
        z_ref = zs[l - 1]

        def pre_nbr(z):
            delta = (z - z_ref) @ w_next
            return q_nbr + torch.einsum(spec, rows, delta)

        if l + 1 < n_l:
            nxt = nbr_vals(zh[l])

            def obj_lanes(z):
                r1 = z - target1
                v1 = 0.5 * admm.nu * torch.sum(r1 * r1, dim=(1, 2))
                r2 = (nxt - f(pre_nbr(z))) * wt
                v2 = 0.5 * admm.nu * torch.sum(r2 * r2, dim=(1, 2, 3))
                return v1 + v2
        else:
            last, uv = nbr_vals(zh[l]), nbr_vals(self.gather(u))

            def obj_lanes(z):
                r1 = z - target1
                v1 = 0.5 * admm.nu * torch.sum(r1 * r1, dim=(1, 2))
                r2 = (last - pre_nbr(z)) * wt
                lin = torch.sum(uv * r2, dim=(1, 2, 3))
                quad = 0.5 * admm.rho * torch.sum(r2 * r2, dim=(1, 2, 3))
                return v1 + lin + quad
        return obj_lanes

    def inputs(self, zs_plane, u_plane, use_kernel: bool):
        """Blocked iterates, gathered copies and the layer-input aggregates.

        The reference aggregates the same gathered tensor more than once
        per step (``rowagg(zh[0])`` at repro/core/parallel.py:786, :813 and
        :892, and ``rowagg(zh0)`` at :786 and :811).  Here each layer input
        is aggregated once and reused: the same operands give the same
        value, so no result changes and the kernel runs L + 1 times per
        step instead of 3L.
        """
        zs = [self.from_plane(z) for z in zs_plane]
        u = self.from_plane(u_plane)
        zh0 = self.gather(self.z0)
        zh = [self.gather(z) for z in zs]
        zh_in = [zh0] + zh[:-1]
        aggs = [self.rowagg(x, use_kernel) for x in zh_in]
        return zs, u, zh, aggs

    def __call__(self, state: ParallelState, use_kernel: bool
                 ) -> ParallelState:
        admm, n_l = self.admm, self.cfg.num_layers
        zs, u, zh, aggs = self.inputs(state.zs, state.u, use_kernel)

        # ---- Line 3: W update (layer-parallel, Jacobi over Z^k) ----
        new_ws, new_taus = [], []
        for l, obj in enumerate(self.w_objectives(aggs, zs, u)):
            w_new, tau = backtracking_step(obj, state.weights[l],
                                           state.taus[l], admm)
            new_ws.append(w_new)
            new_taus.append(tau)

        # ---- Line 4: Z update (community-parallel, reads W^{k+1}, Z^k) ----
        new_zs, new_thetas = [], []
        for l in range(1, n_l):
            obj_lanes = self.z_objective(l, aggs, zh, zs, u, new_ws[l - 1],
                                         new_ws[l])
            z_new, theta = backtracking_step_lanes(
                obj_lanes, zs[l - 1], state.thetas[l - 1], admm)
            new_zs.append(z_new)
            new_thetas.append(theta)

        # ---- Z_L: per-community FISTA prox (eq. 7) ----
        b = aggs[n_l - 1] @ new_ws[-1]
        z_last = fista_lanes(admm, b, u, self.labels, self.mask, zs[-1],
                             self.denom)
        new_zs.append(z_last)
        new_thetas.append(state.thetas[-1])

        # ---- Line 5: dual ascent (eq. 3) with updated iterates ----
        if n_l >= 2:
            agg_pen = self.rowagg(self.gather(new_zs[n_l - 2]), use_kernel)
        else:
            agg_pen = aggs[0]
        new_u = u + admm.rho * (new_zs[-1] - agg_pen @ new_ws[-1])

        return ParallelState(tuple(new_ws),
                             tuple(self.to_plane(z) for z in new_zs),
                             self.to_plane(new_u), tuple(new_taus),
                             tuple(new_thetas))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class ParallelADMMTrainer:
    """The paper's 'Parallel ADMM': M community agents as lanes of one
    device.  ``device=None`` means ``cuda`` (RuntimeError without one);
    tests pass ``device="cpu"``."""

    def __init__(self, cfg: gcn.GCNConfig, admm: ADMMConfig, g: graph.Graph,
                 num_parts: int, seed: int = 0,
                 config: TrainerConfig | None = None,
                 part: np.ndarray | None = None,
                 device: "str | torch.device | None" = None):
        config = TrainerConfig() if config is None else config
        why = _unsupported(config)
        if why is not None:
            raise NotImplementedError(why)
        self.device = device = resolve_device(device)
        self.config = config
        self.cfg, self.admm, self.graph = cfg, admm, g
        self.transport = config.transport
        self.packed = packed = config.packed
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
        self.partition_stats = graph.partition_quality(
            g.num_nodes, g.edges, part, num_parts)
        self.layout = graph.build_community_layout(
            g.num_nodes, g.edges, part, compressed=config.compressed,
            pad_mode=pad_mode)
        m = int(np.asarray(self.layout.neighbor_mask).shape[0])

        self.packed_layout = self.layout.device_layout(1) if packed else None
        self.data = community_data(g, self.layout,
                                   compressed=config.compressed,
                                   adjacency_bf16=config.adjacency_bf16,
                                   device_layout=self.packed_layout,
                                   device=device)

        # init from the same forward pass as the serial trainer
        gen = torch.Generator().manual_seed(seed)
        ws = gcn.init_weights(cfg, gen, device)
        a_full = torch.as_tensor(
            graph.normalized_adjacency(g.num_nodes, g.edges), device=device)
        zs_full = gcn.forward(cfg, a_full,
                              torch.as_tensor(g.features, device=device), ws)
        del a_full
        zs = tuple(self._to_state(z.cpu().numpy()) for z in zs_full)
        u = torch.zeros_like(zs[-1])
        taus = tuple(torch.tensor(admm.tau_init, dtype=torch.float32,
                                  device=device) for _ in ws)
        thetas = tuple(torch.full((m,), admm.tau_init, dtype=torch.float32,
                                  device=device) for _ in zs)
        self.state = ParallelState(tuple(ws), zs, u, taus, thetas)

        packed_aux = None
        if packed:
            dl = self.packed_layout

            def table(x):
                return torch.as_tensor(np.asarray(x)[0], dtype=torch.long,
                                       device=device)
            packed_aux = {"k": int(dl.lanes_per_shard), "n": int(dl.n_pad),
                          "unpack": table(dl.unpack_rows),
                          "pack": table(dl.pack_rows)}
        self._body = _Body(cfg, admm, self.data, packed_aux)
        self.comm_stats = self._comm_stats()

        # metrics/Lagrangian run on the blocked (M, n_pad, ...) view; in
        # packed mode the state planes are rebuilt through the device
        # layout's global row table (take-with-fill, lossless under the
        # zero-outside-counts contract)
        if packed:
            self._gup = torch.as_tensor(
                self.packed_layout.global_unpack_rows(), dtype=torch.long,
                device=device)
        data = self.data
        self._z0_blk = self._unfold(data.z0)
        self._labels_blk = self._unfold(data.labels)
        self._train_blk = self._unfold(data.train_mask)
        self._test_blk = self._unfold(data.test_mask)
        self._row_mask = data.row_mask[..., None]

    # -- state layout ------------------------------------------------------

    def _to_state(self, x: np.ndarray) -> Tensor:
        """(N, C) node rows -> the trainer's resident state layout."""
        blk = self.layout.pack(x)
        if self.packed:
            blk = self.packed_layout.pack_state(blk)
        return torch.as_tensor(blk, device=self.device)

    def _unfold(self, p: Tensor) -> Tensor:
        if not self.packed:
            return p
        m, n = self.layout.num_parts, self.layout.n_pad
        return _take_fill(p, self._gup).reshape((m, n) + tuple(p.shape[1:]))

    # -- accounting ----------------------------------------------------------

    def _comm_stats(self) -> dict:
        """The reference's ``comm_stats`` keys that need no exchange plan:
        gathered bytes, padding, adjacency and resident-state accounting.
        The plan-derived keys (wire bytes of the p2p schedule, overlap
        pricing) come with the multi-shard slice."""
        cfg, lay = self.cfg, self.layout
        dims = list(cfg.layer_dims)
        gathered_cs = [dims[0]] + dims[1:]
        if cfg.num_layers >= 2:
            gathered_cs += dims[2:] + [dims[-1], dims[-2]]
        cs = messages.gather_bytes(lay.neighbor_mask, lay.n_pad, gathered_cs,
                                   itemsize=4)
        cs["transport"] = self.transport
        cs["pad_mode"] = self.pad_mode
        # pad rows drop out of the FLOPs only in the guarded ELL kernel
        kernel_ragged = self.config.compressed and self.use_kernel
        wire_ragged = self.transport == "p2p"
        ps_flops = messages.pad_stats(
            lay.neighbor_mask, lay.sizes,
            lay.row_counts if kernel_ragged else None, lay.n_pad,
            gathered_cs, itemsize=4)
        ps_wire = messages.pad_stats(
            lay.neighbor_mask, lay.sizes,
            lay.row_counts if wire_ragged else None, lay.n_pad,
            gathered_cs, itemsize=4)
        cs.update(ps_wire)
        cs.update({k: ps_flops[k] for k in
                   ("pad_flops", "agg_flops", "pad_flop_frac")})
        cs["pad_guards"] = {"kernel": kernel_ragged, "wire": wire_ragged}
        cs["partitioner"] = self.partitioner
        cs["partition"] = dict(self.partition_stats)
        if self.transport == "allgather":
            # an all-gather moves every row to every shard
            cs["wire_bytes"] = cs["full_bytes"]
        cs["adjacency"] = messages.adjacency_bytes(
            lay.neighbor_mask, lay.n_pad,
            itemsize=2 if self.config.adjacency_bf16 else 4)
        cs["adjacency"]["resident_bytes"] = int(self.data.adjacency_nbytes)
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
        cs["minibatch"] = {"enabled": False}
        return cs

    # -- the step ------------------------------------------------------------

    @torch.no_grad()
    def next_state(self, state: "ParallelState | None" = None,
                   use_kernel: "bool | None" = None) -> ParallelState:
        """One ADMM iteration from ``state`` (default: the current state)
        without changing the trainer; ``use_kernel`` overrides the
        configured aggregation path."""
        state = self.state if state is None else state
        use_kernel = self.use_kernel if use_kernel is None else use_kernel
        return self._body(state, use_kernel)

    def step(self) -> None:
        self.state = self.next_state()

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
        with torch.no_grad():
            zs, u, zh, aggs = body.inputs(st.zs, st.u, use_kernel)
        out = {"w": [], "z": []}
        for l, obj in enumerate(body.w_objectives(aggs, zs, u)):
            out["w"].append(value_and_grad(obj, st.weights[l]))
        for l in range(1, self.cfg.num_layers):
            obj = body.z_objective(l, aggs, zh, zs, u, st.weights[l - 1],
                                   st.weights[l])
            out["z"].append(value_and_grad(obj, zs[l - 1]))
        return out

    # -- metrics -------------------------------------------------------------

    def _agg_full(self, z: Tensor) -> Tensor:
        """Full-M aggregation of the metrics and the Lagrangian, whatever
        ``use_kernel`` says, as in the reference (repro/core/parallel.py:
        1317-1334): the ELL kernel on the card in compressed mode, the
        masked einsum in dense mode."""
        return self._body.rowagg(z, use_kernel=self.config.compressed)

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
        val = torch.sum(nll[..., 0] * self._train_blk) / self.data.denom
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

    def train(self, epochs: int, verbose: bool = False) -> TrainLog:
        log = TrainLog()
        for epoch in range(epochs):
            self._sync()
            t0 = time.perf_counter()
            self.step()
            self._sync()
            dt = time.perf_counter() - t0
            tr, te, res = self._metrics(self.state)
            lag = self._lagrangian(self.state)
            log.epoch.append(epoch)
            log.train_acc.append(float(tr))
            log.test_acc.append(float(te))
            log.lagrangian.append(float(lag))
            log.residual.append(float(res))
            log.epoch_time_s.append(dt)
            if verbose:
                print(f"[parallel-admm] epoch {epoch:3d} train {tr:.3f} "
                      f"test {te:.3f} lagr {lag:.4f} res {res:.2e} "
                      f"({dt*1e3:.1f} ms)")
        return log
