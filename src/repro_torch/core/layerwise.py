"""Layerwise ADMM for transformer stacks — the paper's technique beyond GCN,
the port of src/repro/core/layerwise.py.

Every layer of every segment is an ADMM block with its own auxiliary
activation Z_b and the constraint Z_b = F_b(Z_{b-1}); the W and Z
subproblems of all blocks are solved at once (Jacobi), each block's step
by its own backtracking curvature (the paper's per-block τ and θ), the
readout by a gradient step, and the last constraint carries the dual U
(dual ascent).  Z_0 is the frozen embedding of the batch, as the paper's
input matrix.

The reference ``vmap``s one block over the stacked layer axis; here the
blocks run in a loop over that axis.  Its line search is a
``lax.while_loop``; here each probe reads ``done.all()`` on the host once
(``probes`` counts these reads, ``searches`` the searches).  The
reference shards blocks and batch over a device mesh; the port runs on one
device, and a mesh is ROADMAP queue A item 5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.build import Model, _next_token_ce
from repro_torch.util import tree

# host reads of the line searches (one per probe) and searches run
probes = 0
searches = 0

_MESH = ("layerwise ADMM over a device mesh (blocks over 'model', batch "
         "over 'data') is ROADMAP queue A item 5 (the process transport)")


class LayerwiseState(NamedTuple):
    stack: Any                 # stacked per-segment weights (as Model)
    readout: Any               # final_norm + unembed params
    zs: dict                   # segment -> (n_layers, B, S, D) activations
    u: torch.Tensor            # dual for the last constraint (B, S, D) f32
    taus: dict                 # segment -> (n_layers,) curvatures for W
    thetas: dict               # segment -> (n_layers,) curvatures for Z
    tau_r: torch.Tensor        # readout curvature


def _tree_lane_norm_sq(tree_, lanes: int) -> torch.Tensor:
    """Per-lane squared norms over a tree with leading lane dim."""
    leaves = tree.leaves(tree_)
    total = torch.zeros((lanes,), dtype=torch.float32,
                        device=leaves[0].device)
    for leaf in leaves:
        total = total + torch.sum(
            torch.square(leaf.float()).reshape(lanes, -1), dim=1)
    return total


def lane_backtracking_tree(obj_lanes: Callable, x, theta0: torch.Tensor,
                           admm: ADMMConfig):
    """Per-lane majorize-minimize step on a TREE with leading lane dim.

    obj_lanes(x) -> (lanes,).  Lanes accept independently (paper's per-block
    τ_l / per-community θ_{l,m}); frozen lanes stop doubling.  The gradient
    is autograd's over the tree's leaves; the probes run without it.
    """
    global probes, searches
    searches += 1
    lanes = theta0.shape[0]
    xs = tree.leaves(x)
    live = [leaf.detach().requires_grad_(True) for leaf in xs]
    with torch.enable_grad():
        vals = obj_lanes(tree.unflatten(x, live))
        grads = torch.autograd.grad(vals.sum(), live, allow_unused=True,
                                    materialize_grads=True)
    vals = vals.detach()
    del live
    g_sq = _tree_lane_norm_sq(grads, lanes)

    def step(theta):
        inv = 1.0 / theta
        return tree.unflatten(x, [
            (xx.float() - gg.float()
             * inv.reshape((lanes,) + (1,) * (gg.dim() - 1))).to(xx.dtype)
            for xx, gg in zip(xs, grads)])

    def accepted(theta):
        bound = vals - 0.5 * g_sq / theta
        tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
        return obj_lanes(step(theta)) <= bound + tol

    with torch.no_grad():
        theta = torch.clamp(theta0 / admm.backtrack_growth, min=1e-8)
        done = accepted(theta)
        it = 0
        while it < admm.max_backtracks:
            probes += 1
            if bool(done.all()):
                break
            theta = torch.where(done, theta, theta * admm.backtrack_growth)
            done = done | accepted(theta)
            it += 1
        return step(theta), theta


def _add_last(vals: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """``vals.at[-1].add(extra)`` for a scalar ``extra``, out of place."""
    return torch.cat([vals[:-1], vals[-1:] + extra])


def _lane_sq(r: torch.Tensor) -> torch.Tensor:
    return torch.sum(r * r, dim=tuple(range(1, r.dim())))


@dataclasses.dataclass
class LayerwiseADMMTrainer:
    """Blockwise-ADMM training of a transformer on a fixed batch."""

    cfg: ModelConfig
    admm: ADMMConfig
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(_MESH)
        self.cfg = dataclasses.replace(self.cfg, remat=False)
        self.model = Model(self.cfg)
        self.segments = [s for s in transformer.arch_segments(self.cfg)
                         if s.kind != "enc"]

    # -------------------------------------------------------------- helpers

    def _apply_blocks(self, kind: str, stacked_w, inputs: torch.Tensor):
        """Each block of the stacked layer axis on its own input:
        F_b(Z_{b-1})."""
        if inputs.shape[0] == 0:
            # empty block stack (the within-segment coupling of a
            # single-block segment)
            return torch.zeros_like(inputs)
        outs = [transformer.apply_layer(self.cfg, kind, w, x)[0]
                for w, x in zip(transformer._layers(stacked_w,
                                                    inputs.shape[0]),
                                inputs.unbind(0))]
        return torch.stack(outs, dim=0)

    @staticmethod
    def _shifted_inputs(z0: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
        """[Z_0, Z_1, ..., Z_{L-1}]."""
        return torch.cat([z0[None], zs[:-1]], dim=0)

    def _readout_logits(self, readout, z_last):
        h = L.apply_norm(self.cfg, readout["final_norm"], z_last)
        return L.unembed(self.cfg, readout["embedding"], h)

    # ----------------------------------------------------------------- init

    @torch.no_grad()
    def init(self, seed: int, batch: dict,
             device: "str | torch.device | None" = None):
        """(state, Z_0): weights drawn from ``seed`` as ``Model.init`` (on
        the card unless ``device`` says otherwise), each Z_b from the
        forward pass, U = 0, every τ and θ at ``tau_init``."""
        params = self.model.init(seed, device)
        dev = params["final_norm"]["scale"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        z0 = self.model._embed_inputs(params, batch)
        zs, taus, thetas = {}, {}, {}
        x = z0
        for seg in self.segments:
            outs = []
            for w_b in transformer._layers(params["stack"][seg.kind],
                                           seg.count):
                x, _ = transformer.apply_layer(self.cfg, seg.kind, w_b, x)
                outs.append(x)
            zs[seg.kind] = torch.stack(outs, dim=0)
            taus[seg.kind] = torch.full((seg.count,), self.admm.tau_init,
                                        dtype=torch.float32, device=dev)
            thetas[seg.kind] = taus[seg.kind].clone()
        readout = {"final_norm": params["final_norm"],
                   "embedding": params["embedding"]}
        u = torch.zeros_like(zs[self.segments[-1].kind][-1],
                             dtype=torch.float32)
        tau_r = torch.tensor(self.admm.tau_init, dtype=torch.float32,
                             device=dev)
        return LayerwiseState(params["stack"], readout, zs, u, taus, thetas,
                              tau_r), z0

    # ------------------------------------------------------------ iteration

    @torch.no_grad()
    def iteration(self, state: LayerwiseState, z0: torch.Tensor,
                  targets: torch.Tensor) -> LayerwiseState:
        admm, cfg = self.admm, self.cfg
        segs = self.segments
        last_kind = segs[-1].kind
        targets = torch.as_tensor(targets, device=z0.device)

        # ---- W update: all blocks of all segments in parallel (Jacobi) ----
        new_stack, new_taus = {}, {}
        seg_in = z0
        for seg in segs:
            zsk = state.zs[seg.kind]
            inputs = self._shifted_inputs(seg_in, zsk)
            is_last_seg = seg.kind == last_kind

            def w_obj(stacked_w, zsk=zsk, inputs=inputs, seg=seg,
                      is_last=is_last_seg):
                pred = self._apply_blocks(seg.kind, stacked_w, inputs)
                r = (zsk - pred).float()
                vals = 0.5 * admm.nu * _lane_sq(r)
                if is_last:
                    # last block carries the augmented-Lagrangian terms
                    r_last = r[-1]
                    lin = torch.sum(state.u * r_last)
                    quad = 0.5 * (admm.rho - admm.nu) * torch.sum(
                        r_last * r_last)
                    vals = _add_last(vals, lin + quad)
                return vals

            new_w, tau = lane_backtracking_tree(
                w_obj, state.stack[seg.kind], state.taus[seg.kind], admm)
            new_stack[seg.kind] = new_w
            new_taus[seg.kind] = tau
            seg_in = zsk[-1]

        # ---- readout update (R's own parameters, gradient step) ----
        z_last = state.zs[last_kind][-1]

        def r_obj(readout):
            return _next_token_ce(self._readout_logits(readout, z_last),
                                  targets)

        new_readout, tau_r = lane_backtracking_tree(
            lambda ro: r_obj(ro)[None], state.readout, state.tau_r[None],
            admm)
        tau_r = tau_r[0]

        # ---- Z update: all blocks in parallel (reads W^{k+1}, Z^k) ----
        new_zs, new_thetas = {}, {}
        seg_in = z0
        for si, seg in enumerate(segs):
            zsk = state.zs[seg.kind]
            w_new = new_stack[seg.kind]
            inputs = self._shifted_inputs(seg_in, zsk)
            targets_blocks = self._apply_blocks(seg.kind, w_new, inputs)
            is_last_seg = seg.kind == last_kind

            # cross-segment coupling: the last block of segment si feeds the
            # FIRST block of segment si+1 — F_{si+1,0}(Z_{si,last}) vs
            # Z_{si+1,0}^k.  When that next block is the network's final
            # block, this edge is the dualized constraint and carries the
            # augmented-Lagrangian terms.
            if not is_last_seg:
                nseg = segs[si + 1]
                w_x0 = transformer._layer(new_stack[nseg.kind], 0)
                z_x_ref = state.zs[nseg.kind][0]
                x_is_final = nseg.kind == last_kind and nseg.count == 1
            else:
                nseg = w_x0 = z_x_ref = None
                x_is_final = False

            def z_obj(zsk_var, targets_blocks=targets_blocks, seg=seg,
                      w_new=w_new, zsk=zsk, is_last=is_last_seg,
                      nseg=nseg, w_x0=w_x0, z_x_ref=z_x_ref,
                      x_is_final=x_is_final):
                r1 = (zsk_var - targets_blocks).float()
                vals = 0.5 * admm.nu * _lane_sq(r1)
                # coupling: blocks 0..L-2 feed block b+1 (within segment)
                w_next = transformer.tree_map(lambda leaf: leaf[1:], w_new)
                pred_next = self._apply_blocks(seg.kind, w_next,
                                               zsk_var[:-1])
                r2 = (zsk[1:] - pred_next).float()
                v2 = 0.5 * admm.nu * _lane_sq(r2)
                if is_last and v2.shape[0]:
                    r2_last = r2[-1]
                    lin = torch.sum(state.u * r2_last)
                    quad = 0.5 * (admm.rho - admm.nu) * torch.sum(
                        r2_last * r2_last)
                    v2 = _add_last(v2, lin + quad)
                vals = torch.cat([vals[:-1] + v2, vals[-1:]])
                # coupling across the segment boundary (last lane)
                if nseg is not None:
                    pred_x, _ = transformer.apply_layer(
                        cfg, nseg.kind, w_x0, zsk_var[-1])
                    r2x = (z_x_ref - pred_x).float()
                    vx = 0.5 * admm.nu * torch.sum(r2x * r2x)
                    if x_is_final:
                        vx = vx + torch.sum(state.u * r2x) + \
                            0.5 * (admm.rho - admm.nu) * torch.sum(r2x * r2x)
                    vals = _add_last(vals, vx)
                # last block of last segment: CE readout term
                if is_last:
                    ce = _next_token_ce(
                        self._readout_logits(new_readout, zsk_var[-1]),
                        targets)
                    vals = _add_last(vals, ce)
                return vals

            z_new, theta = lane_backtracking_tree(
                z_obj, zsk, state.thetas[seg.kind], admm)
            new_zs[seg.kind] = z_new
            new_thetas[seg.kind] = theta
            seg_in = zsk[-1]

        # ---- dual ascent on the last constraint ----
        seg = segs[-1]
        zsk_new = new_zs[seg.kind]
        prev_in = z0 if len(segs) == 1 and seg.count == 1 else (
            zsk_new[-2] if seg.count > 1 else new_zs[segs[-2].kind][-1])
        w_last = transformer._layer(new_stack[seg.kind], -1)
        pred_last, _ = transformer.apply_layer(cfg, seg.kind, w_last,
                                               prev_in)
        residual = (zsk_new[-1] - pred_last).float()
        new_u = state.u + admm.rho * residual

        return LayerwiseState(new_stack, new_readout, new_zs, new_u,
                              new_taus, new_thetas, tau_r)

    # ---------------------------------------------------------------- train

    @torch.no_grad()
    def metrics(self, state: LayerwiseState, z0: torch.Tensor,
                targets: torch.Tensor):
        """CE of the *composed* network (no auxiliary Z) + residual norm."""
        x = z0
        for seg in self.segments:
            for w in transformer._layers(state.stack[seg.kind], seg.count):
                x, _ = transformer.apply_layer(self.cfg, seg.kind, w, x)
        targets = torch.as_tensor(targets, device=x.device)
        ce = _next_token_ce(self._readout_logits(state.readout, x), targets)
        last = self.segments[-1].kind
        res = torch.linalg.vector_norm(
            (state.zs[last][-1] - x).float()) / math.sqrt(x.numel())
        return ce, res
