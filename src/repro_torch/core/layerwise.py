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
(``probes`` counts these reads, ``searches`` the searches).

With ``mesh`` (a ``launch.mesh.ProcessMesh`` of ``data`` × ``model``
ranks) the reference's placement — blocks over ``model``, batch over
``data`` (its ``_constraint_spec``) — becomes each rank's own part.  The
network's blocks, segment after segment, are cut into ``model``
contiguous ranges of near-equal length (the first ``NB mod model`` ranks
one longer); each rank holds its blocks' W, Z, τ and θ for its data
shard's rows, and the last model rank the readout, U and τ_R.  What
crosses ranks, each a collective of its own (``messages.
MeshCollectives``):

  * ``init`` and ``metrics``: the forward pipelined along ``model``;
  * the shifted input [Z_0, Z_1 … Z_{L-1}] of the W and Z updates: the
    previous model rank's last Z^k (and the next rank's first Z^k, the
    target of this rank's last lane's coupling), one message each way;
  * the coupling of a rank's last lane in the Z update: the next model
    rank's first W^{k+1} (and U when that block is the network's last),
    once an iteration; the dual's input Z^{k+1}_{NB-2} when the last rank
    holds one block;
  * every objective value is a sum over the whole batch: each line
    search's values, each probe and the W and readout gradients (the Z
    gradient's per-lane norm) are summed over ``data`` with the same bits
    on every data rank, so the data ranks of a lane decide alike.

Lanes decide independently, so each model rank searches its own lanes; a
lane's τ/θ is the one-process search's, its objective summed in another
order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.messages import MeshCollectives, gather_parts
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch.mesh import batch_rows
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer
from repro_torch.models.build import Model, _next_token_ce
from repro_torch.util import tree

# host reads of the line searches (one per probe) and searches run
probes = 0
searches = 0

# the tags of the messages along 'model', one per purpose
_HALO, _COUPLE, _DUAL, _PIPE = range(4)


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
                           admm: ADMMConfig, data: "Callable | None" = None,
                           shared: bool = False):
    """Per-lane majorize-minimize step on a TREE with leading lane dim.

    obj_lanes(x) -> (lanes,).  Lanes accept independently (paper's per-block
    τ_l / per-community θ_{l,m}); frozen lanes stop doubling.  The gradient
    is autograd's over the tree's leaves; the probes run without it.

    With ``data`` (a sum over the data ranks of a list of tensors, in
    place, the same bits on every rank) ``obj_lanes`` is this rank's rows'
    part of the objective: the values and every probe are summed over
    ``data``, and so is the gradient when ``x`` is ``shared`` (whole on
    every data rank: W, the readout), else only its per-lane squared norm
    (``x`` cut by rows: Z).
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
    if data is not None and shared:
        grads = data(list(grads) + [vals])[:-1]
    g_sq = _tree_lane_norm_sq(grads, lanes)
    if data is not None and not shared:
        data([vals, g_sq])

    def step(theta):
        inv = 1.0 / theta
        return tree.unflatten(x, [
            (xx.float() - gg.float()
             * inv.reshape((lanes,) + (1,) * (gg.dim() - 1))).to(xx.dtype)
            for xx, gg in zip(xs, grads)])

    def accepted(theta):
        bound = vals - 0.5 * g_sq / theta
        tol = admm.backtrack_rtol * (torch.abs(bound) + 1e-12)
        probe = obj_lanes(step(theta))
        if data is not None:
            data([probe])
        return probe <= bound + tol

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
        self.cfg = dataclasses.replace(self.cfg, remat=False)
        self.model = Model(self.cfg)
        self.segments = [s for s in transformer.arch_segments(self.cfg)
                         if s.kind != "enc"]
        if self.mesh is not None:
            self._place()

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
        forward pass, U = 0, every τ and θ at ``tau_init``.  Over a mesh:
        this rank's part (``batch`` is the global batch; the device is the
        mesh's)."""
        if self.mesh is not None:
            with self._moe_rows():
                return self._mesh_init(seed, batch)
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
        if self.mesh is not None:
            with self._moe_rows():
                return self._mesh_iteration(state, z0, targets)
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
        """CE of the *composed* network (no auxiliary Z) + residual norm.
        Over a mesh every rank returns the whole batch's values."""
        if self.mesh is not None:
            with self._moe_rows():
                return self._mesh_metrics(state, z0, targets)
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

    # ------------------------------------------------ over a mesh of ranks

    def _place(self) -> None:
        """This rank's blocks: the network's NB blocks, segment after
        segment, cut into ``model`` contiguous ranges of near-equal length
        (``torch.tensor_split``'s sizes)."""
        self.comm = MeshCollectives(self.mesh)
        n_model, m = self.comm.model.world_size, self.comm.model.rank
        self._kinds = [seg.kind for seg in self.segments
                       for _ in range(seg.count)]
        nb = len(self._kinds)
        if n_model > nb:
            raise ValueError(f"{nb} blocks cannot cover {n_model} model "
                             f"ranks")
        q, r = divmod(nb, n_model)
        self._lo = m * q + min(m, r)
        self._hi = self._lo + q + (m < r)
        self._first = m == 0
        self._last = m == n_model - 1
        # (segment, lo, hi, index of its block lo in the network)
        self.local, start = [], 0
        for seg in self.segments:
            lo = max(self._lo - start, 0)
            hi = min(self._hi - start, seg.count)
            if hi > lo:
                self.local.append((seg, lo, hi, start + lo))
            start += seg.count
        self._n_dp = self.comm.data.world_size
        self._layer_like: dict = {}

    def _moe_rows(self):
        """MoE capacity couples the batch's rows: over several data ranks
        each dispatches its rows as the global batch would (``moe.
        global_rows``), with the per-expert counts of the data ranks
        before it (one all-gather of E counts per MoE layer applied)."""
        data = self.comm.data
        if self.cfg.moe is None or data.world_size == 1:
            return contextlib.nullcontext()

        def offsets(counts):
            parts = gather_parts(data, counts)
            return sum(parts[:data.rank], torch.zeros_like(counts))
        return moe.global_rows(data.world_size, offsets)

    def _rows_of(self, n: int) -> None:
        self._batch = n
        self._rows = batch_rows(self.mesh, n)

    def _cut(self, x) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (a tensor already cut
        passes through)."""
        x = torch.as_tensor(x, device=self.mesh.device)
        return x[self._rows] if x.shape[0] == self._batch else x

    def _keep_layer_shapes(self, stack) -> None:
        """One layer of each segment kind as meta tensors: the shapes of
        the next model rank's first W, which this rank receives."""
        for kind, stacked in stack.items():
            self._layer_like[kind] = tree.tree_map(
                lambda leaf: torch.empty(leaf.shape[1:], dtype=leaf.dtype,
                                         device="meta"), stacked)

    def shard_state(self, state: LayerwiseState, z0: torch.Tensor):
        """This rank's part of a one-process state (``init`` / ``iteration``
        with ``mesh=None``), on the mesh's device: its blocks of every
        segment and its rows of Z, Z_0 and U; the readout, U and τ_R on the
        last model rank only."""
        dev = self.mesh.device
        self._rows_of(z0.shape[0])
        rows = self._rows
        stack, zs, taus, thetas = {}, {}, {}, {}
        for seg, lo, hi, _ in self.local:
            k = seg.kind
            stack[k] = tree.tree_map(lambda t: t[lo:hi].to(dev).clone(),
                                     state.stack[k])
            zs[k] = state.zs[k][lo:hi, rows].to(dev).clone()
            taus[k] = state.taus[k][lo:hi].to(dev).clone()
            thetas[k] = state.thetas[k][lo:hi].to(dev).clone()
        self._keep_layer_shapes(state.stack)
        last = self._last
        return LayerwiseState(
            stack,
            tree.tree_map(lambda t: t.to(dev).clone(), state.readout)
            if last else None,
            zs, state.u[rows].to(dev).clone() if last else None, taus,
            thetas, state.tau_r.to(dev).clone() if last else None), \
            z0[rows].to(dev).clone()

    def _forward_local(self, stack, x: torch.Tensor, keep: bool):
        """The pipelined forward: Z_{lo-1} from the previous model rank,
        this rank's blocks, its last Z to the next; with ``keep`` every
        block's output (per local segment)."""
        like = [(tuple(x.shape), x.dtype)]
        if not self._first:
            (x,), _ = self.comm.shift(_PIPE, from_prev=like)
        outs = {}
        for seg, lo, hi, _ in self.local:
            ys = []
            for w in transformer._layers(stack[seg.kind], hi - lo):
                x, _ = transformer.apply_layer(self.cfg, seg.kind, w, x)
                if keep:
                    ys.append(x)
            if keep:
                outs[seg.kind] = torch.stack(ys, dim=0)
        if not self._last:
            self.comm.shift(_PIPE, to_next=[x])
        return x, outs

    def _mesh_init(self, seed: int, batch: dict):
        dev = self.mesh.device
        params = self.model.init(seed, dev)
        self._rows_of(len(batch["tokens"]))
        local = {k: self._cut(v) for k, v in batch.items()}
        z0 = self.model._embed_inputs(params, local)
        self._keep_layer_shapes(params["stack"])
        stack = {}
        for seg, lo, hi, _ in self.local:
            stack[seg.kind] = tree.tree_map(lambda t: t[lo:hi].clone(),
                                            params["stack"][seg.kind])
        readout = {"final_norm": params["final_norm"],
                   "embedding": params["embedding"]} if self._last else None
        del params
        _, zs = self._forward_local(stack, z0, keep=True)
        taus, thetas = {}, {}
        for seg, lo, hi, _ in self.local:
            taus[seg.kind] = torch.full((hi - lo,), self.admm.tau_init,
                                        dtype=torch.float32, device=dev)
            thetas[seg.kind] = taus[seg.kind].clone()
        last_kind = self.local[-1][0].kind
        u = torch.zeros_like(zs[last_kind][-1], dtype=torch.float32) \
            if self._last else None
        tau_r = torch.tensor(self.admm.tau_init, dtype=torch.float32,
                             device=dev) if self._last else None
        return LayerwiseState(stack, readout, zs, u, taus, thetas,
                              tau_r), z0

    def _data_sum(self, tensors):
        return self.comm.sum_data(tensors)

    def _ce(self, readout, z, targets) -> torch.Tensor:
        """This rank's rows' part of the batch's mean next-token CE."""
        return _next_token_ce(self._readout_logits(readout, z), targets) \
            / self._n_dp

    def _mesh_iteration(self, state: LayerwiseState, z0: torch.Tensor,
                        targets) -> LayerwiseState:
        admm, cfg, comm = self.admm, self.cfg, self.comm
        nb = len(self._kinds)
        targets = self._cut(targets)
        local = self.local
        first_z = state.zs[local[0][0].kind][0]
        last_z = state.zs[local[-1][0].kind][-1]
        zlike = [(tuple(first_z.shape), first_z.dtype)]

        # ---- Z^k across the rank boundaries, both ways ----
        halo, z_next_ref = comm.shift(
            _HALO, to_prev=None if self._first else [first_z],
            to_next=None if self._last else [last_z],
            from_prev=None if self._first else zlike,
            from_next=None if self._last else zlike)
        seg_ins = [z0 if self._first else halo[0]]
        for seg, _, _, _ in local[:-1]:
            seg_ins.append(state.zs[seg.kind][-1])

        # ---- W update: this rank's blocks (Jacobi) ----
        new_stack, new_taus = {}, {}
        for i, (seg, lo, hi, g0) in enumerate(local):
            zsk = state.zs[seg.kind]
            inputs = self._shifted_inputs(seg_ins[i], zsk)
            carries_u = g0 + (hi - lo) == nb     # holds the network's last

            def w_obj(stacked_w, zsk=zsk, inputs=inputs, seg=seg,
                      carries_u=carries_u):
                pred = self._apply_blocks(seg.kind, stacked_w, inputs)
                r = (zsk - pred).float()
                vals = 0.5 * admm.nu * _lane_sq(r)
                if carries_u:
                    r_last = r[-1]
                    lin = torch.sum(state.u * r_last)
                    quad = 0.5 * (admm.rho - admm.nu) * torch.sum(
                        r_last * r_last)
                    vals = _add_last(vals, lin + quad)
                return vals

            new_w, tau = lane_backtracking_tree(
                w_obj, state.stack[seg.kind], state.taus[seg.kind], admm,
                data=self._data_sum, shared=True)
            new_stack[seg.kind] = new_w
            new_taus[seg.kind] = tau

        # ---- readout update on the last model rank ----
        new_readout, tau_r = state.readout, state.tau_r
        if self._last:
            z_last = state.zs[local[-1][0].kind][-1]
            new_readout, tau_r = lane_backtracking_tree(
                lambda ro: self._ce(ro, z_last, targets)[None],
                state.readout, state.tau_r[None], admm,
                data=self._data_sum, shared=True)
            tau_r = tau_r[0]

        # ---- W^{k+1} (and U) of the next model rank's first block ----
        first_kind = local[0][0].kind
        u_shape = [(tuple(first_z.shape), torch.float32)]
        to_prev = None
        if not self._first:
            to_prev = tree.leaves(transformer._layer(new_stack[first_kind],
                                                     0))
            if self._lo == nb - 1:
                to_prev = to_prev + [state.u]
        from_next = None
        if not self._last:
            like = self._layer_like[self._kinds[self._hi]]
            from_next = [(tuple(t.shape), t.dtype) for t in tree.leaves(like)]
            if self._hi == nb - 1:
                from_next = from_next + u_shape
        _, got = comm.shift(_COUPLE, to_prev=to_prev, from_next=from_next)
        if got is not None:
            n_leaves = len(tree.leaves(like))
            w_next_rank = tree.unflatten(like, got[:n_leaves])
            u_next_rank = got[n_leaves] if self._hi == nb - 1 else None

        # ---- Z update: this rank's blocks (reads W^{k+1}, Z^k) ----
        new_zs, new_thetas = {}, {}
        for i, (seg, lo, hi, g0) in enumerate(local):
            zsk = state.zs[seg.kind]
            w_new = new_stack[seg.kind]
            inputs = self._shifted_inputs(seg_ins[i], zsk)
            targets_blocks = self._apply_blocks(seg.kind, w_new, inputs)
            is_final = g0 + (hi - lo) == nb
            # the last lane feeds the network's next block: here (the next
            # segment's first) or on the next model rank
            if i + 1 < len(local):
                nkind = local[i + 1][0].kind
                w_x = transformer._layer(new_stack[nkind], 0)
                z_x_ref = state.zs[nkind][0]
                u_x = state.u if local[i + 1][3] == nb - 1 else None
            elif not self._last:
                nkind = self._kinds[self._hi]
                w_x, z_x_ref, u_x = w_next_rank, z_next_ref[0], u_next_rank
            else:
                nkind = w_x = z_x_ref = u_x = None

            def z_obj(zsk_var, targets_blocks=targets_blocks, seg=seg,
                      w_new=w_new, zsk=zsk, is_final=is_final, nkind=nkind,
                      w_x=w_x, z_x_ref=z_x_ref, u_x=u_x):
                r1 = (zsk_var - targets_blocks).float()
                vals = 0.5 * admm.nu * _lane_sq(r1)
                # coupling: local blocks b feed b + 1
                w_next = transformer.tree_map(lambda leaf: leaf[1:], w_new)
                pred_next = self._apply_blocks(seg.kind, w_next,
                                               zsk_var[:-1])
                r2 = (zsk[1:] - pred_next).float()
                v2 = 0.5 * admm.nu * _lane_sq(r2)
                if is_final and v2.shape[0]:
                    r2_last = r2[-1]
                    lin = torch.sum(state.u * r2_last)
                    quad = 0.5 * (admm.rho - admm.nu) * torch.sum(
                        r2_last * r2_last)
                    v2 = _add_last(v2, lin + quad)
                vals = torch.cat([vals[:-1] + v2, vals[-1:]])
                # coupling of the last lane to the network's next block
                if nkind is not None:
                    pred_x, _ = transformer.apply_layer(cfg, nkind, w_x,
                                                        zsk_var[-1])
                    r2x = (z_x_ref - pred_x).float()
                    vx = 0.5 * admm.nu * torch.sum(r2x * r2x)
                    if u_x is not None:
                        vx = vx + torch.sum(u_x * r2x) + \
                            0.5 * (admm.rho - admm.nu) * torch.sum(r2x * r2x)
                    vals = _add_last(vals, vx)
                if is_final:
                    vals = _add_last(vals, self._ce(new_readout, zsk_var[-1],
                                                    targets))
                return vals

            z_new, theta = lane_backtracking_tree(
                z_obj, zsk, state.thetas[seg.kind], admm,
                data=self._data_sum, shared=False)
            new_zs[seg.kind] = z_new
            new_thetas[seg.kind] = theta

        # ---- dual ascent on the last constraint (last model rank) ----
        new_u = state.u
        sends = self._hi == nb - 1 and not self._last
        gets = self._last and self._lo == nb - 1 and nb > 1
        got = None
        if sends or gets:
            got, _ = comm.shift(
                _DUAL, to_next=[new_zs[local[-1][0].kind][-1]]
                if sends else None, from_prev=zlike if gets else None)
        if self._last:
            seg, lo, hi, _ = local[-1]
            zsk_new = new_zs[seg.kind]
            if nb == 1:
                prev_in = z0
            elif hi - lo > 1:
                prev_in = zsk_new[-2]
            elif len(local) > 1:
                prev_in = new_zs[local[-2][0].kind][-1]
            else:
                prev_in = got[0]
            w_last = transformer._layer(new_stack[seg.kind], -1)
            pred_last, _ = transformer.apply_layer(cfg, seg.kind, w_last,
                                                   prev_in)
            residual = (zsk_new[-1] - pred_last).float()
            new_u = state.u + admm.rho * residual

        return LayerwiseState(new_stack, new_readout, new_zs, new_u,
                              new_taus, new_thetas, tau_r)

    def _mesh_metrics(self, state: LayerwiseState, z0: torch.Tensor,
                      targets):
        x, _ = self._forward_local(state.stack, z0, keep=False)
        out = torch.zeros(2, dtype=torch.float32, device=self.mesh.device)
        if self._last:
            targets = self._cut(targets)
            ce = self._ce(state.readout, x, targets)
            d = (state.zs[self.local[-1][0].kind][-1] - x).float()
            out = torch.stack([ce.float(), torch.sum(d * d)])
            self._data_sum([out])
            out[1] = torch.sqrt(out[1]) / math.sqrt(x.numel() * self._n_dp)
        out = self.comm.from_last_model_rank(out)
        return out[0], out[1]
