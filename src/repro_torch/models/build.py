"""Top-level Model API of the port: init / forward / loss / prefill /
decode_step / input_specs — the counterpart of src/repro/models/build.py
for the ``ssm`` architecture (Mamba-2).

Batch format: {'tokens': (B, S) int, 'targets': (B, S) int}.  Parameters
are nested dicts of tensors with the reference's key paths and its stacked
leading layer axis (``convert.model_params_from_numpy`` carries a JAX tree
across).  ``init`` draws them from a ``torch.Generator`` on the device
(the reference's distributions, not its numbers).  ``device=None`` means
the card and raises without one (``util.device.resolve_device``).

Training (``train_step``, ``train_step_deferred``, ``init_optimizer``, the
MTP loss) and the encoder, vision and attention families raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Params
from repro_torch.util.device import resolve_device

DEC_FRACTION = 8           # enc-dec training: dec_len = seq_len // 8
_TRAINING = ("ROADMAP queue A item 2 (language-model training: train_step, "
             "optim/schedules.py, launch/train.py, core/layerwise.py)")
_FAMILIES = ("ROADMAP queue A item 1 (attention families: attention, MoE, "
             "RG-LRU and encoder-decoder forward and decode)")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init

    def init(self, seed: int = 0,
             device: "str | torch.device | None" = None) -> Params:
        cfg = self.cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params: Params = {
            "embedding": layers.init_embedding(cfg, gen),
            "stack": transformer.init_stack(cfg, gen),
            "final_norm": layers.init_norm(cfg, cfg.d_model, device),
        }
        if cfg.mtp_depth:
            raise NotImplementedError(f"the MTP block: {_TRAINING}")
        return params

    def init_optimizer(self):
        raise NotImplementedError(_TRAINING)

    # --------------------------------------------------------------- forward

    def _embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        if self.cfg.arch_type == "vlm":
            raise NotImplementedError(f"vision embeddings: {_FAMILIES}")
        return layers.embed(params["embedding"], batch["tokens"])

    def forward(self, params: Params, batch: dict, *,
                window: Optional[int] = None,
                use_kernel: bool = False,
                last_only: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full forward. Returns (logits f32, aux_loss, hidden).

        ``last_only`` restricts the unembed to the final position (prefill:
        avoids materializing the (B, S, V) logits buffer)."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        if cfg.is_encoder_decoder:
            self.encode(params, batch["frames"], use_kernel=use_kernel)
        x = self._embed_inputs(params, batch)
        x, aux = transformer.apply_stack(cfg, params["stack"], x,
                                         window=window,
                                         use_kernel=use_kernel)
        h = layers.apply_norm(cfg, params["final_norm"], x)
        logits = layers.unembed(cfg, params["embedding"],
                                h[:, -1:] if last_only else h)
        return logits, aux, h

    def encode(self, params: Params, frames: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
        raise NotImplementedError(f"the encoder: {_FAMILIES}")

    # ----------------------------------------------------------------- loss

    def loss(self, params: Params, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        logits, aux, h = self.forward(params, batch)
        ce = _next_token_ce(logits, batch["targets"])
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if self.cfg.mtp_depth:
            mtp_ce = self._mtp_loss(params, h, batch)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def _mtp_loss(self, params: Params, h: torch.Tensor,
                  batch: dict) -> torch.Tensor:
        raise NotImplementedError(f"the MTP loss: {_TRAINING}")

    # ------------------------------------------------------------ train step

    def train_step(self, params: Params, opt_state, batch: dict):
        raise NotImplementedError(_TRAINING)

    def train_step_deferred(self, mesh, params: Params, opt_state,
                            batch: dict):
        raise NotImplementedError(_TRAINING)

    # ------------------------------------------------------- prefill / decode

    def prefill(self, params: Params, batch: dict, max_len: int, *,
                rolling: bool = False) -> tuple[torch.Tensor, Params]:
        """Forward over the prompt; returns (last-token logits, caches).

        As in the reference, the caches come back zero: the forward pass
        (logits and final hidden) is the prefill's work, and a server fills
        the caches by decode steps."""
        logits, _, _ = self.forward(params, batch)
        caches = self.init_cache(batch["tokens"].shape[0], max_len,
                                 rolling=rolling, device=logits.device)
        return logits[:, -1:], caches

    def init_cache(self, batch: int, max_len: int, *, rolling: bool = False,
                   device: "str | torch.device | None" = None) -> Params:
        return transformer.init_stack_cache(self.cfg, batch, max_len,
                                            rolling, resolve_device(device))

    def decode_step(self, params: Params, caches: Params,
                    tokens: torch.Tensor, *, rolling: bool = False
                    ) -> tuple[torch.Tensor, Params]:
        """ONE new token (B, 1) against the caches."""
        cfg = self.cfg
        x = layers.embed(params["embedding"], tokens)
        x, caches = transformer.decode_stack(cfg, params["stack"], caches, x,
                                             rolling=rolling)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        logits = layers.unembed(cfg, params["embedding"], x)
        return logits, caches

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


def _next_token_ce(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


def make_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    return Model(cfg)
