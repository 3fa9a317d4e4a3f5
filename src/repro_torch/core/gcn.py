"""GCN model (Kipf & Welling) in the paper's notation.

``Z_l = f_l(Ã Z_{l-1} W_l)`` for l < L and ``Z_L = Ã Z_{L-1} W_L`` (logits).
The port's counterpart of ``repro.core.gcn``.  Weights come from a
``torch.Generator``: JAX's ``jax.random`` Glorot draws cannot be reproduced
without JAX, so parity tests inject the JAX weights (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    layer_dims: tuple[int, ...]   # (C_0, C_1, ..., C_L)
    activation: str = "relu"      # f_l for l < L

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1


def activation_fn(name: str) -> Callable[[Tensor], Tensor]:
    return {"relu": torch.relu, "tanh": torch.tanh,
            "identity": lambda x: x}[name]


def init_weights(cfg: GCNConfig, generator: torch.Generator,
                 device: "torch.device | str" = "cpu") -> list[Tensor]:
    """Glorot init, one W_l per layer, drawn on the CPU from ``generator``
    (the same numbers on every device) and moved to ``device``."""
    ws = []
    for l in range(cfg.num_layers):
        fan_in, fan_out = cfg.layer_dims[l], cfg.layer_dims[l + 1]
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32)
        ws.append((scale * w).to(device))
    return ws


def forward(cfg: GCNConfig, a_tilde: Tensor, z0: Tensor,
            weights: Sequence[Tensor]) -> list[Tensor]:
    """Full forward pass; returns [Z_1, ..., Z_L] (Z_L = logits)."""
    f = activation_fn(cfg.activation)
    zs = []
    z = z0
    num_layers = cfg.num_layers
    for l, w in enumerate(weights):
        z = a_tilde @ z @ w
        if l < num_layers - 1:
            z = f(z)
        zs.append(z)
    return zs


def masked_cross_entropy(logits: Tensor, labels: Tensor, mask: Tensor
                         ) -> Tensor:
    """R(Z_L, Y): mean cross-entropy over masked (labeled) nodes."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1)
    return torch.sum(nll * mask) / denom


def accuracy(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    pred = torch.argmax(logits, dim=-1)
    hits = (pred == labels).to(mask.dtype) * mask
    return hits.sum() / torch.clamp(mask.sum(), min=1)
