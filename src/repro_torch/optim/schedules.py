"""Learning-rate schedules (pure functions step -> f32 scale factor), the
port of src/repro/optim/schedules.py.

``step`` is a Python int or an integer tensor; each schedule gives a 0-dim
f32 tensor with the reference's f32 value.  With a Python int the ratios
are formed in double precision and rounded once to f32, as JAX rounds a
Python float; with a tensor they are f32 divisions, as for a JAX int32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.util.tree import tree_map


def _f32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(x, dtype=torch.float32, device=device)


def constant():
    return lambda step: _f32(1.0, step)


def _warm(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp(_f32((step + 1) / max(warmup_steps, 1), step),
                       max=1.0)


def linear_warmup(warmup_steps: int):
    return lambda step: _warm(step, warmup_steps)


def cosine_decay(total_steps: int, warmup_steps: int = 0,
                 final_scale: float = 0.1):
    """Linear warmup then cosine decay to final_scale."""
    def fn(step):
        warm = _warm(step, warmup_steps)
        t = torch.clamp(_f32((step - warmup_steps)
                             / max(total_steps - warmup_steps, 1), step),
                        0.0, 1.0)
        cos = final_scale + (1 - final_scale) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return warm * cos
    return fn


def make(name: str, total_steps: int, warmup_steps: int = 0):
    if name == "constant":
        return constant()
    if name == "warmup":
        return linear_warmup(warmup_steps)
    if name == "cosine":
        return cosine_decay(total_steps, warmup_steps)
    raise KeyError(f"unknown schedule {name!r}")


def scale_updates(updates, scale: torch.Tensor):
    """Each tensor of the tree times ``scale`` in its own dtype."""
    return tree_map(lambda u: u * scale.to(u.dtype)
                    if isinstance(u, torch.Tensor) else u, updates)
