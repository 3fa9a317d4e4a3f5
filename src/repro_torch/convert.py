"""Numpy parameters and trainer state to the port's tensors.

The JAX trainer initialises its weights from ``jax.random``, which cannot be
reproduced without JAX, so the port draws its own from a
``torch.Generator``.  To run both from one state, take the reference's
``ParallelState`` leaves with ``np.asarray`` and hand them to
``state_from_numpy``; the layouts of the two packages are equal array for
array, so the leaves drop in unchanged.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.parallel import ParallelState
from repro_torch.util.device import resolve_device


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def weights_from_numpy(weights: Sequence[np.ndarray],
                       device: "str | torch.device | None" = None
                       ) -> tuple[torch.Tensor, ...]:
    """W_1..W_L as f32 tensors on ``device`` (copies, never views)."""
    device = resolve_device(device)
    return tuple(_tensor(w, device) for w in weights)


def state_from_numpy(weights: Sequence[np.ndarray],
                     zs: Sequence[np.ndarray], u: np.ndarray,
                     taus: Sequence, thetas: Sequence[np.ndarray],
                     device: "str | torch.device | None" = None
                     ) -> ParallelState:
    """A ``ParallelState`` of f32 tensors: weights, iterates and dual in
    the trainer's resident layout (strided or packed), τ as 0-dim tensors
    and θ as (M,) tensors."""
    device = resolve_device(device)
    return ParallelState(weights_from_numpy(weights, device),
                         tuple(_tensor(z, device) for z in zs),
                         _tensor(u, device),
                         tuple(_tensor(t, device) for t in taus),
                         tuple(_tensor(t, device) for t in thetas))
