"""Top-level Model API of the port: init / forward / encode / loss /
prefill / decode_step / input_specs — the counterpart of
src/repro/models/build.py for every architecture family.

Batch formats (``input_specs`` returns matching stand-ins):
  text archs   {'tokens': (B,S) int, 'targets': (B,S) int}
  vlm          + 'vision_embeds': (B,P,D)   (stub frontend)
  audio encdec {'frames': (B,S_enc,D), 'tokens': (B,S_dec), 'targets': ...}

Parameters are nested dicts of tensors with the reference's key paths and
its stacked leading layer axis (``convert.model_params_from_numpy`` carries
a JAX tree across).  ``init`` draws them from a ``torch.Generator`` on the
device (the reference's distributions, not its numbers).  ``device=None``
means the card and raises without one (``util.device.resolve_device``).

Under ``sharding.hints.sharding_hints`` over a ``ProcessMesh`` the
forward paths (``forward``, ``prefill``, ``decode_step``) run this rank's
share, on its slices by ``param_specs`` (``init(mesh=...)``) and
``cache_specs`` (``init_cache(mesh=...)``): ``transformer.
apply_stack_ranks`` / ``decode_stack_ranks``.

Training (``init_optimizer``, ``train_step``, ``train_step_deferred``)
takes the reference's plain route (``use_kernel=False``: no kernel of the
port has a backward pass, as no Pallas kernel of the reference has a VJP).
Gradients come from autograd; under ``cfg.remat`` each layer is
recomputed in the backward pass (``transformer.apply_stack``).  A step
returns new parameters and writes the optimizer's moments over the state
passed in (``optim.optimizers``).  Over the ranks of a
``launch.mesh.ProcessMesh``, ``train_step_deferred`` with the parameters
placed by ``param_specs`` (and the Adam state by ``opt_state_specs``) is
split over ``model`` as the reference's XLA splits it: ``loss`` runs the
rank's share (the cross-entropy vocabulary-parallel on its block of the
logits) and its backward pass goes through the ``model``-axis
collectives; with the parameters whole on every rank the ``model`` axis
holds replicas (the data-parallel step).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Params
from repro_torch.optim import optimizers
from repro_torch.sharding import hints, partition
from repro_torch.util import tree
from repro_torch.util.device import resolve_device, shapes_only

# vision prefix length comes from cfg.frontend.num_embeddings (stub ViT)
AUDIO_MEMORY = 1536        # encoder frames held as decode memory
DEC_FRACTION = 8           # enc-dec training: dec_len = seq_len // 8


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init

    def init(self, seed: int = 0,
             device: "str | torch.device | None" = None,
             mesh=None) -> Params:
        """The parameters; with ``mesh`` (a ``launch.mesh.ProcessMesh``)
        this rank's slices of them by ``param_specs``: every leaf is drawn
        in the one-process order (a stacked leaf one layer at a time) and
        only the rank's slice kept, so the slices are bit for bit those of
        the one-process init and no rank holds the whole model."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        keep = None if mesh is None else partition.slicer(cfg, mesh)

        def kept(tree_, *prefix):
            return tree_ if keep is None else keep(tree_, prefix)
        params: Params = {
            "embedding": kept(layers.init_embedding(cfg, gen), "embedding"),
            "stack": transformer.init_stack(cfg, gen, keep),
            "final_norm": kept(layers.init_norm(cfg, cfg.d_model, device),
                               "final_norm"),
        }
        if cfg.mtp_depth:
            params["mtp"] = kept({
                "proj": layers.dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                          layers.dtype_of(cfg)),
                "layer": transformer.init_layer(cfg, "attn_mlp", gen),
                "norm": layers.init_norm(cfg, cfg.d_model, device),
            }, "mtp")
        if cfg.is_encoder_decoder:
            params["enc_final_norm"] = kept(
                layers.init_norm(cfg, cfg.d_model, device), "enc_final_norm")
        return params

    def param_specs(self, mesh):
        """``partition.param_specs`` of this model's tree on ``mesh``."""
        return partition.param_specs(self.cfg, mesh, _param_shapes(self.cfg))

    def init_optimizer(self):
        return optimizers.make(self.cfg.optimizer, self.cfg.learning_rate)

    # --------------------------------------------------------------- forward

    def _embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        x = layers.embed(params["embedding"], batch["tokens"])
        if self.cfg.arch_type == "vlm":
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        return x

    def _layout(self, batch: int, seq: int):
        """The active hints' ``RankLayout`` of a call (None without
        ranks); the archs that compute whole on these ranks
        (``transformer.split_arch``) keep the residual whole along
        ``model``."""
        lay = hints.rank_layout(batch, seq)
        if lay is not None \
                and not transformer.split_arch(self.cfg, lay.nm):
            lay = dataclasses.replace(lay, seq_split=False)
        return lay

    def _residual_extent(self, batch: dict) -> tuple[int, int]:
        b, s = batch["tokens"].shape[:2]
        if self.cfg.arch_type == "vlm":
            s += self.cfg.frontend.num_embeddings
        return b, s

    def forward(self, params: Params, batch: dict, *,
                window: Optional[int] = None,
                use_kernel: bool = False,
                last_only: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full forward. Returns (logits f32, aux_loss, hidden).

        ``last_only`` restricts the unembed to the final position (prefill:
        avoids materializing the (B, S, V) logits buffer).

        Under ``sharding_hints`` over a ``ProcessMesh`` this rank runs its
        share (``_forward_ranks``): ``params`` are its slices by
        ``param_specs``, ``batch`` the global batch (every rank the same);
        it returns its block of the logits (its rows, its vocabulary
        columns: the reference's ``P(data, None, model)``), the aux loss
        (the same on every rank) and its piece of the final hidden (the
        vision prefix's positions included)."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        lay = self._layout(*self._residual_extent(batch))
        if lay is not None:
            return self._forward_ranks(params, batch, lay, window,
                                       use_kernel, last_only)
        memory = None
        if cfg.is_encoder_decoder:
            memory = self.encode(params, batch["frames"],
                                 use_kernel=use_kernel)
        x = self._embed_inputs(params, batch)
        only = ("dec",) if cfg.is_encoder_decoder else None
        x, aux = transformer.apply_stack(cfg, params["stack"], x,
                                         window=window, memory=memory,
                                         use_kernel=use_kernel,
                                         only_kinds=only)
        h = layers.apply_norm(cfg, params["final_norm"], x)
        if cfg.arch_type == "vlm":
            h = h[:, cfg.frontend.num_embeddings:]
        logits = layers.unembed(cfg, params["embedding"],
                                h[:, -1:] if last_only else h)
        return logits, aux, h

    def _rank_specs(self, mesh):
        """``param_specs`` as this call sees the parameters: inside a
        manual region (the deferred step's, over the data axes) without
        the manual axes, whose slices the step gathered on entry."""
        specs = self.param_specs(mesh)
        manual = hints.manual_axes()
        if not manual:
            return specs
        return partition.map_specs(
            lambda spec: partition.drop_axes(spec, manual), specs)

    def _prefix(self) -> int:
        """The positions before the text in the residual (the vision
        prefix), 0 for the other archs."""
        cfg = self.cfg
        return cfg.frontend.num_embeddings if cfg.arch_type == "vlm" else 0

    def _hidden_ranks(self, params: Params, batch: dict, lay, window,
                      use_kernel: bool):
        """This rank's share of the stack: (its piece of the final hidden
        — the vision prefix's positions included —, aux, its slice of the
        embedding, its rows of the batch).

        An encoder-decoder's encoder runs on a layout of its own frames
        (``_layout`` of S_enc), and its output is entered whole along
        ``model`` once (``RankLayout.enter``: its gradient by the
        encoder's convention) for every decoder layer's cross-attention
        on the rank's heads.  The vision prefix goes before the embedded
        tokens in the (P + S)-position residual that ``lay`` lays out."""
        cfg = self.cfg
        specs = self._rank_specs(lay.mesh)
        dev = tree.leaves(params)[0].device
        local = {k: torch.as_tensor(v, device=dev)[lay.rows]
                 for k, v in batch.items()}
        emb = partition.gather(params["embedding"], specs["embedding"],
                               lay.mesh, lay.comm, hints.DATA_AXES)
        memory = None
        if cfg.is_encoder_decoder:
            frames = local["frames"]
            enc = self._layout(lay.batch, frames.shape[1])
            x, _ = transformer.apply_stack_ranks(
                cfg, params["stack"], specs["stack"], enc.piece(frames), enc,
                use_kernel=use_kernel, only_kinds=("enc",))
            memory = layers.apply_norm(cfg, params["enc_final_norm"], x)
            if transformer.split_arch(cfg, lay.nm):
                memory = enc.enter(memory)
        x = layers.embed_ranks(cfg, emb, local["tokens"], lay,
                               local.get("vision_embeds"))
        x, aux = transformer.apply_stack_ranks(
            cfg, params["stack"], specs["stack"], x, lay, window=window,
            memory=memory, use_kernel=use_kernel,
            only_kinds=("dec",) if cfg.is_encoder_decoder else None)
        h = layers.apply_norm(cfg, params["final_norm"], x)
        return h, aux, emb, local

    def _forward_ranks(self, params: Params, batch: dict, lay, window,
                       use_kernel: bool, last_only: bool):
        h, aux, emb, _ = self._hidden_ranks(params, batch, lay, window,
                                            use_kernel)
        if last_only:
            last = lay.comm.from_last_model_rank(h[:, -1:]) \
                if lay.seq_split else h[:, -1:]
        else:
            last = lay.enter(h)[:, self._prefix():]
        return layers.unembed(self.cfg, emb, last), aux, h

    def encode(self, params: Params, frames: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
        """Encoder over stubbed frame embeddings (enc-dec archs): the
        ``enc`` segment (bidirectional, no window), then its final norm.
        The reference's encoder runs no kernel; here ``use_kernel`` takes
        its self-attention through the flash kernel, non-causal."""
        cfg = self.cfg
        x, _ = transformer.apply_stack(cfg, params["stack"], frames,
                                       use_kernel=use_kernel,
                                       only_kinds=("enc",))
        return layers.apply_norm(cfg, params["enc_final_norm"], x)

    # ----------------------------------------------------------------- loss

    def loss(self, params: Params, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        """(ce + aux [+ 0.3 · MTP ce], metrics).  Under ``sharding_hints``
        over a ``ProcessMesh`` this rank's share (``_loss_ranks``)."""
        lay = self._layout(*self._residual_extent(batch))
        if lay is not None:
            return self._loss_ranks(params, batch, lay)
        logits, aux, h = self.forward(params, batch)
        ce = _next_token_ce(logits, batch["targets"])
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if self.cfg.mtp_depth:
            mtp_ce = self._mtp_loss(params, h, batch)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def _loss_ranks(self, params: Params, batch: dict, lay
                    ) -> tuple[torch.Tensor, dict]:
        """The loss of this rank's rows, split over ``model``: ``params``
        its slices, the cross-entropy vocabulary-parallel on its block of
        the logits (``layers.next_token_ce_ranks``), the same value on
        every rank of a model line.  Gradients flow through the
        ``model``-axis collectives (``sharding.hints``' conventions);
        they are taken inside the deferred step's data-manual region,
        where the batch is this data rank's rows."""
        cfg = self.cfg
        if torch.is_grad_enabled() and hints.data_ranks(lay.mesh) > 1:
            raise ValueError(
                "gradients of the loss over ranks are taken per data rank, "
                "in train_step_deferred's region manual over the data axes "
                "(hints.manual_region): here the data axes split the batch")
        h, aux, emb, local = self._hidden_ranks(params, batch, lay,
                                                cfg.sliding_window, False)
        ce = layers.next_token_ce_ranks(cfg, emb, h, local["targets"], lay,
                                        prefix=self._prefix())
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss_ranks(params, h, emb, local, lay)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def _mtp_loss_ranks(self, params: Params, h: torch.Tensor, emb: Params,
                        local: dict, lay) -> torch.Tensor:
        """``_mtp_loss`` on this rank: ``h`` its piece of the final
        hidden.  Where the layers split (``transformer.split_arch``) the
        projection is all-gathered along ``model`` (the rank forms its
        positions' rows of [h ; emb] · proj) and the block runs split
        (``apply_layer_ranks``); else both are gathered whole and run on
        the whole residual.  The cross-entropy of position t against
        target t + 1 crosses the boundary between two ranks' pieces
        (``next_token_ce_ranks``' ``shift``)."""
        cfg = self.cfg
        split = transformer.split_arch(cfg, lay.nm)
        specs = self._rank_specs(lay.mesh)
        mtp = transformer.gather_layer(params["mtp"], specs["mtp"], lay,
                                       whole=not split)
        e_t = layers.embed_ranks(cfg, emb, local["targets"], lay)
        x = torch.cat([h, e_t.to(h.dtype)], dim=-1)
        if split:
            x = x @ lay.whole(mtp["proj"], 1, cfg.d_model,
                              "scatter" if lay.seq_split else "slice")
            x, _ = transformer.apply_layer_ranks(cfg, "attn_mlp",
                                                 mtp["layer"], x, lay)
        else:
            x, _ = transformer.apply_layer(cfg, "attn_mlp", mtp["layer"],
                                           x @ mtp["proj"], lay=lay)
        x = layers.apply_norm(cfg, mtp["norm"], x)
        return layers.next_token_ce_ranks(cfg, emb, x, local["targets"], lay,
                                          shift=1)

    def _mtp_loss(self, params: Params, h: torch.Tensor,
                  batch: dict) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: one extra block predicts
        token t+2 from [h_t ; emb(target_t)]."""
        cfg = self.cfg
        emb = layers.embed(params["embedding"], batch["targets"])
        x = torch.cat([h, emb.to(h.dtype)], dim=-1) @ params["mtp"]["proj"]
        x, _ = transformer.apply_layer(cfg, "attn_mlp",
                                       params["mtp"]["layer"], x)
        x = layers.apply_norm(cfg, params["mtp"]["norm"], x)
        logits = layers.unembed(cfg, params["embedding"], x[:, :-1])
        return _next_token_ce(logits, batch["targets"][:, 1:])

    # ------------------------------------------------------------ train step

    def _on_device(self, params: Params, batch: dict) -> dict:
        dev = tree.leaves(params)[0].device
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def _micro(self, batch: dict, accum: int) -> list[dict]:
        """The batch cut along its leading axis into ``accum`` microbatches
        (the reference's reshape to (accum, B/accum, ...))."""
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        return [{k: v[i] for k, v in micro.items()} for i in range(accum)]

    def _apply(self, params: Params, opt_state, grads: list, loss_val,
               metrics: dict):
        opt = self.init_optimizer()
        updates, opt_state = opt.update(tree.unflatten(params, grads),
                                        opt_state, params)
        params = tree.tree_map(lambda w, u: w + u.to(w.dtype), params,
                               updates)
        return params, opt_state, dict(metrics, loss=loss_val)

    def train_step(self, params: Params, opt_state, batch: dict):
        """One optimizer step; with cfg.grad_accum > 1 the global batch is
        split into microbatches whose gradients are summed in the
        parameters' dtype (the reference's ``zeros_like(params)`` scan
        carry: here autograd's accumulation into ``.grad``), divided once
        by the count, then applied."""
        batch = self._on_device(params, batch)
        accum = self.cfg.grad_accum
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        live_tree = tree.unflatten(params, live)
        if accum <= 1:
            loss_val, metrics = self.loss(live_tree, batch)
            grads = list(torch.autograd.grad(loss_val, live,
                                             allow_unused=True,
                                             materialize_grads=True))
            loss_val = loss_val.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=live[0].device)
            mets = []
            for mb in self._micro(batch, accum):
                lv, m = self.loss(live_tree, mb)
                lv.backward()
                loss_sum = loss_sum + lv.detach()
                mets.append({k: v.detach() for k, v in m.items()})
            grads = [torch.zeros_like(p) if p.grad is None
                     else p.grad.div_(accum) for p in live]
            loss_val = loss_sum / accum
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        del live, live_tree
        return self._apply(params, opt_state, grads, loss_val, metrics)

    def train_step_deferred(self, mesh, params: Params, opt_state,
                            batch: dict, comm=None):
        """Gradient accumulation with the data-parallel reduction deferred
        to one sum after the microbatches (the reference's shard_map form):
        each microbatch's gradients are summed in f32.  On one device
        (``mesh`` None, or ``launch.mesh``'s one-device mesh) that sum is
        the whole reduction.

        Over a ``launch.mesh.ProcessMesh`` this process is one rank and
        ``batch`` holds its rows of the global batch (``TokenPipeline(
        mesh=...)`` places them; ``launch.mesh.batch_rows`` cuts them).
        The step runs, as the reference's, in a region manual over the
        data axes (``sharding.hints.manual_region``: its ``shard_map``),
        where the all-to-all MoE dispatch is gated off.  After its
        microbatches ONE reduction over the data axes sums the gradients,
        the loss sum and the metrics (``messages.MeshCollectives.
        sum_data``, ``comm``, made here when not given: f32 buckets, each
        all-gathered and summed in rank order, so every rank adds the same
        parts in the same order and ends with the same bits); then, as in
        the reference, the sums are divided by ``accum · n_dp``, the
        metrics are ``m.mean() / n_dp``, and every rank applies the
        update.

        ``params`` placed by ``param_specs`` (``init(mesh=...)``; the Adam
        state then by ``partition.opt_state_specs``, as ``init_optimizer()
        .init`` of them makes it): the step is split over ``model`` as
        the reference's XLA splits it (``_train_step_ranks``).  ``params``
        whole on every rank: the ``model`` axis holds replicas (the
        data-parallel step), the model ranks of a data row compute the
        same shard, and each bucket's sum is broadcast along the row so
        they stay equal."""
        from repro_torch.launch.mesh import ProcessMesh
        ranks = isinstance(mesh, ProcessMesh)
        if not ranks and mesh is not None and mesh.size > 1:
            raise ValueError(f"a one-process mesh drives one device, not "
                             f"{mesh.size}: run data-parallel training over "
                             f"the ranks of a launch.mesh.ProcessMesh")
        if ranks and comm is None:
            from repro_torch.core.messages import MeshCollectives
            comm = MeshCollectives(mesh)
        if ranks and self._placed(params):
            return self._train_step_ranks(mesh, params, opt_state, batch,
                                          comm)
        batch = self._on_device(params, batch)
        accum = max(self.cfg.grad_accum, 1)
        live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        live_tree = tree.unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in live]
        loss_sum = torch.zeros((), dtype=torch.float32, device=live[0].device)
        mets = []
        # the reference's shard_map, manual over the data axes; the model
        # axis holds replicas, so nothing is split over it either
        with hints.manual_region(hints.DATA_AXES + ("model",)):
            for mb in self._micro(batch, accum):
                lv, m = self.loss(live_tree, mb)
                g = torch.autograd.grad(lv, live, allow_unused=True,
                                        materialize_grads=True)
                for a, b in zip(acc, g):
                    a.add_(b)
                del g
                loss_sum = loss_sum + lv.detach()
                mets.append({k: v.detach() for k, v in m.items()})
        del live, live_tree
        stacked = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
        if not ranks:
            grads = [a.div_(accum) for a in acc]
            loss_val = loss_sum / accum
            metrics = {k: v.mean() for k, v in stacked.items()}
            return self._apply(params, opt_state, grads, loss_val, metrics)
        # THE deferred reduction: one sum over the data axes, in buckets
        names = sorted(stacked)
        small = torch.cat([loss_sum.reshape(1)]
                          + [stacked[k].float() for k in names])
        comm.sum_data(acc + [small], replicas=True)
        n_dp = comm.data.world_size
        grads = [a.div_(accum * n_dp) for a in acc]
        loss_val = small[0] / (accum * n_dp)
        metrics = {k: small[1 + i * accum:1 + (i + 1) * accum].mean() / n_dp
                   for i, k in enumerate(names)}
        return self._apply(params, opt_state, grads, loss_val, metrics)

    def _placed(self, params: Params) -> bool:
        """Whether ``params`` are a rank's slices (some leaf short of its
        whole shape) rather than the whole tree."""
        return any(tuple(p.shape) != tuple(f.shape) for p, f in
                   zip(tree.leaves(params),
                       tree.leaves(_param_shapes(self.cfg))))

    def opt_state_specs(self, mesh, opt_state):
        """``partition.opt_state_specs`` of this model's optimizer state
        ``opt_state`` (any rank's, or whole) on ``mesh``."""
        return partition.opt_state_specs(self.cfg, mesh,
                                         _param_shapes(self.cfg), opt_state)

    def _train_step_ranks(self, mesh, params: Params, opt_state,
                          batch: dict, comm):
        """``train_step_deferred`` split over ``model``: each rank holds
        its slices of the parameters (and the Adam state), computes its
        share of each microbatch's loss and of its backward pass
        (``_loss_ranks``, gradients through the ``model``-axis
        collectives) and updates its slices.

        The reference's shard_map gathers the parameters over the data
        axes on entry and reshards them on exit; so here the leaves
        placed over ``data`` (the FSDP leg) are all-gathered over the
        data axes once, their gradients accumulate at that size through
        the microbatches, are summed over ``data`` once and then cut to
        this rank's slice.  Every gradient is summed over the data axes
        in the one ``sum_data`` (no broadcast along ``model``: each model
        rank holds its own slices).  The leaves the same on every rank of
        a model line (norms, routers, unsplit biases) are then made equal
        there: with the residual split each rank's gradient is its
        positions' part, summed over ``model`` in rank order; with the
        residual whole each rank holds the whole gradient, and the first
        model rank's is sent to the others.  An encoder-decoder's encoder
        leaves follow its frames' layout, the rest the decoder's."""
        cfg = self.cfg
        data = hints.DATA_AXES
        specs = self.param_specs(mesh)
        paths = [path for path, _ in tree.leaves_with_paths(params)]
        leaf_specs = [partition.spec_at(specs, path) for path in paths]
        with torch.no_grad():
            work = [partition.gather_leaf(p, sp, mesh, comm, data)
                    for p, sp in zip(tree.leaves(params), leaf_specs)]
        batch = self._on_device(params, batch)
        accum = max(cfg.grad_accum, 1)
        live = [w.detach().requires_grad_(True) for w in work]
        del work
        live_tree = tree.unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in live]
        loss_sum = torch.zeros((), dtype=torch.float32, device=live[0].device)
        mets = []
        with hints.sharding_hints(mesh, hints.moe_a2a_enabled(), comm), \
                hints.manual_region(data):
            for mb in self._micro(batch, accum):
                lv, m = self.loss(live_tree, mb)
                g = torch.autograd.grad(lv, live, allow_unused=True,
                                        materialize_grads=True)
                for a, b in zip(acc, g):
                    a.add_(b)
                del g
                loss_sum = loss_sum + lv.detach()
                mets.append({k: v.detach() for k, v in m.items()})
            split = self._layout(*self._residual_extent(mb)).seq_split
            enc_split = self._layout(mb["frames"].shape[0],
                                     mb["frames"].shape[1]).seq_split \
                if cfg.is_encoder_decoder else split
        del live, live_tree
        stacked = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
        names = sorted(stacked)
        small = torch.cat([loss_sum.reshape(1)]
                          + [stacked[k].float() for k in names])
        comm.sum_data(acc + [small])
        same = [i for i, sp in enumerate(leaf_specs)
                if "model" not in {a for e in sp
                                   for a in partition.entry_axes(e)}]
        groups: dict = {}                  # gradient convention -> leaves
        for i in same if comm.model.world_size > 1 else ():
            groups.setdefault(enc_split if _in_encoder(paths[i]) else split,
                              []).append(i)
        for summed, group in groups.items():
            flat = torch.cat([acc[i].reshape(-1) for i in group])
            flat = comm.sum_model(flat) if summed else \
                comm.broadcast_model(flat, 0)
            off = 0
            for i in group:
                n = acc[i].numel()
                acc[i].reshape(-1).copy_(flat[off:off + n])
                off += n
        n_dp = comm.data.world_size
        grads = [partition.data_slice(a, sp, mesh).div(accum * n_dp)
                 for a, sp in zip(acc, leaf_specs)]
        del acc
        loss_val = small[0] / (accum * n_dp)
        metrics = {k: small[1 + i * accum:1 + (i + 1) * accum].mean() / n_dp
                   for i, k in enumerate(names)}
        return self._apply(params, opt_state, grads, loss_val, metrics)

    # ------------------------------------------------------- prefill / decode

    def prefill(self, params: Params, batch: dict, max_len: int, *,
                rolling: bool = False) -> tuple[torch.Tensor, Params]:
        """Forward over the prompt; returns (last-token logits, caches).

        As in the reference, the caches come back zero: the forward pass
        (logits and final hidden) is the prefill's work, and a server fills
        the caches by decode steps (an encoder-decoder's cross caches from
        ``encode``'s memory)."""
        b = batch["tokens"].shape[0]
        lay = self._layout(*self._residual_extent(batch))
        if lay is not None:              # this rank's share (forward's)
            logits, _, _ = self.forward(params, batch, last_only=True)
            return logits, self.init_cache(b, max_len, rolling=rolling,
                                           device=logits.device,
                                           mesh=lay.mesh)
        logits, _, _ = self.forward(params, batch)
        caches = self.init_cache(b, max_len, rolling=rolling,
                                 device=logits.device)
        return logits[:, -1:], caches

    def init_cache(self, batch: int, max_len: int, *, rolling: bool = False,
                   device: "str | torch.device | None" = None,
                   mesh=None) -> Params:
        """The decode caches; with ``mesh`` this rank's slices of them by
        ``cache_specs`` (made at their local shapes)."""
        memory_len = AUDIO_MEMORY if self.cfg.is_encoder_decoder else 0
        if mesh is None:
            return transformer.init_stack_cache(self.cfg, batch, max_len,
                                                rolling, memory_len,
                                                resolve_device(device))
        with shapes_only():
            full = transformer.init_stack_cache(self.cfg, batch, max_len,
                                                rolling, memory_len,
                                                torch.device("meta"))
        specs = partition.cache_specs(self.cfg, mesh, full)
        return partition.local_filled(full, specs, mesh,
                                      resolve_device(device),
                                      {"slot_pos": -1})

    def _rank_cache_specs(self, caches: Params, batch: int, rolling: bool,
                          mesh):
        """``cache_specs`` of the global caches whose slices on this rank
        are ``caches`` (``init_cache(batch, max_len, mesh=mesh)``).  Only
        the sequence length is not known here: it is a local one as it is,
        or times the ``data`` axis or the data axes (where ``cache_specs``
        splits it over them) — the one whose slices have these shapes."""
        memory_len = AUDIO_MEMORY if self.cfg.is_encoder_decoder else 0
        have = [t.shape for t in tree.leaves(caches)]
        lengths = {t.shape[-1] if path[-1] == "slot_pos" else t.shape[2]
                   for path, t in tree.leaves_with_paths(caches)
                   if path[-1] == "slot_pos" or t.dim() >= 4}
        data = mesh.shape["data"] if "data" in mesh.axis_names else 1
        found = {}
        for n in {n * f for n in lengths or {1}
                  for f in (1, data, hints.dp_size(mesh))}:
            with shapes_only():
                full = transformer.init_stack_cache(
                    self.cfg, batch, n, rolling, memory_len,
                    torch.device("meta"))
                specs = partition.cache_specs(self.cfg, mesh, full)
                local = partition.local_filled(full, specs, mesh, "meta", {})
            if [t.shape for t in tree.leaves(local)] == have:
                found[repr(specs)] = specs
        if len(found) != 1:
            raise ValueError(
                f"decode over ranks takes this rank's slices of the caches "
                f"of init_cache(batch, max_len, mesh=...) or prefill for a "
                f"batch of {batch}: {len(found)} global cache lengths give "
                f"slices of these shapes")
        return found.popitem()[1]

    def decode_step(self, params: Params, caches: Params,
                    tokens: torch.Tensor, *, rolling: bool = False
                    ) -> tuple[torch.Tensor, Params]:
        """ONE new token (B, 1) against the caches.

        Under ``sharding_hints`` over a ``ProcessMesh``: ``params`` and
        ``caches`` are this rank's slices (``init_cache(…, mesh=…)``),
        ``tokens`` the global (B, 1); returns this rank's block of the
        logits, the caches written in place."""
        cfg = self.cfg
        lay = self._layout(tokens.shape[0], 1)
        if lay is not None:
            return self._decode_ranks(params, caches, tokens, lay, rolling)
        x = layers.embed(params["embedding"], tokens)
        x, caches = transformer.decode_stack(cfg, params["stack"], caches, x,
                                             rolling=rolling)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        logits = layers.unembed(cfg, params["embedding"], x)
        return logits, caches

    def _decode_ranks(self, params: Params, caches: Params, tokens, lay,
                      rolling: bool):
        cfg = self.cfg
        cache_specs = self._rank_cache_specs(caches, tokens.shape[0],
                                             rolling, lay.mesh)
        specs = self.param_specs(lay.mesh)
        emb = partition.gather(params["embedding"], specs["embedding"],
                               lay.mesh, lay.comm, hints.DATA_AXES)
        dev = tree.leaves(params)[0].device
        x = layers.embed_ranks(cfg, emb, torch.as_tensor(
            tokens, device=dev)[lay.rows], lay)
        x, caches = transformer.decode_stack_ranks(
            cfg, params["stack"], specs["stack"], caches, cache_specs, x,
            lay, rolling=rolling)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return layers.unembed(cfg, emb, x), caches

    # ------------------------------------------------------------ input specs

    def input_specs(self, shape: InputShape) -> dict:
        """Stand-ins for every model input on the ``meta`` device (shape
        and dtype, no allocation)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = layers.dtype_of(cfg)

        def spec(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")
        if cfg.is_encoder_decoder:
            if shape.step == "train":
                dec = s // DEC_FRACTION
                return {"frames": spec((b, s, cfg.d_model), dt),
                        "tokens": spec((b, dec)),
                        "targets": spec((b, dec))}
            if shape.step == "prefill":
                return {"frames": spec((b, s, cfg.d_model), dt),
                        "tokens": spec((b, 1)),
                        "targets": spec((b, 1))}
            return {"tokens": spec((b, 1))}     # decode
        if cfg.arch_type == "vlm" and shape.step != "decode":
            npfx = cfg.frontend.num_embeddings
            text = s - npfx
            return {"tokens": spec((b, text)),
                    "targets": spec((b, text)),
                    "vision_embeds": spec((b, npfx, cfg.d_model), dt)}
        if shape.step == "decode":
            return {"tokens": spec((b, 1))}
        return {"tokens": spec((b, s)), "targets": spec((b, s))}

    def cache_specs(self, shape: InputShape, *, rolling: bool = False):
        return self.init_cache(shape.global_batch, shape.seq_len,
                               rolling=rolling, device="meta")


def _in_encoder(path) -> bool:
    """Whether a parameter's key path lies in an encoder-decoder's encoder
    (its ``enc`` stack or its final norm)."""
    return tuple(path[:2]) == ("stack", "enc") or path[0] == "enc_final_norm"


def _next_token_ce(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    return layers.next_token_nll(logits, targets).mean()


@functools.lru_cache(maxsize=16)
def _param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of ``cfg`` as ``meta`` tensors (from an init
    under ``FakeTensorMode``: nothing is drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with shapes_only():
        with FakeTensorMode():
            fake = Model(cfg).init(0, "cpu")
        return tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   device="meta"), fake)


def make_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    return Model(cfg)
