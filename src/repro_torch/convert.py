"""Numpy parameters and trainer state to the port's tensors.

The JAX trainer initialises its weights from ``jax.random``, which cannot be
reproduced without JAX, so the port draws its own from a
``torch.Generator``.  To run both from one state, take the reference's
``ParallelState`` (or serial ``ADMMState``) leaves with ``np.asarray`` and
hand them to ``state_from_numpy`` (``serial_state_from_numpy``); the
layouts of the two packages are equal array for array, so the leaves drop
in unchanged.  A baseline's weights go through ``weights_from_numpy``.
A language model's parameter tree (``repro.models.build.Model.init``, each
leaf taken with ``np.asarray``) goes through ``model_params_from_numpy``:
the port keeps the reference's key paths and stacked layer axis.  Its
optimizer state goes through ``opt_state_from_numpy``, and a layerwise
ADMM state (``repro.core.layerwise``) with its Z_0 through
``layerwise_state_from_numpy``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.parallel import ParallelState
from repro_torch.core.subproblems import ADMMState
from repro_torch.util.device import resolve_device


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def weights_from_numpy(weights: Sequence[np.ndarray],
                       device: "str | torch.device | None" = None
                       ) -> tuple[torch.Tensor, ...]:
    """W_1..W_L as f32 tensors on ``device`` (copies, never views)."""
    device = resolve_device(device)
    return tuple(_tensor(w, device) for w in weights)


def _leaves(weights, zs, u, taus, thetas, device):
    device = resolve_device(device)
    return (weights_from_numpy(weights, device),
            tuple(_tensor(z, device) for z in zs), _tensor(u, device),
            tuple(_tensor(t, device) for t in taus),
            tuple(_tensor(t, device) for t in thetas))


def state_from_numpy(weights: Sequence[np.ndarray],
                     zs: Sequence[np.ndarray], u: np.ndarray,
                     taus: Sequence, thetas: Sequence[np.ndarray],
                     device: "str | torch.device | None" = None,
                     lanes: "slice | None" = None) -> ParallelState:
    """A ``ParallelState`` of f32 tensors: weights, iterates and dual in
    the trainer's resident layout (strided or packed), τ as 0-dim tensors
    and θ as (M,) tensors.

    With ``lanes`` (one shard's k lanes, ``slice(s·k, (s+1)·k)``) the state
    is that shard's part of the shared one, as a rank of the process
    transport holds it: its lanes of strided (M, n_pad, C) iterates, its
    rows of packed planes (shard s's ``plane_rows`` rows of the M / k
    planes laid end to end), its lanes of θ; W and τ whole."""
    if lanes is not None:
        k = lanes.stop - lanes.start
        shards, s = len(thetas[0]) // k, lanes.start // k
        rows = lanes
        if np.ndim(zs[0]) == 2:                       # packed planes
            pr = len(zs[0]) // shards
            rows = slice(s * pr, (s + 1) * pr)
        zs = [np.asarray(z)[rows] for z in zs]
        u = np.asarray(u)[rows]
        thetas = [np.asarray(t)[lanes] for t in thetas]
    return ParallelState(*_leaves(weights, zs, u, taus, thetas, device))


def gather_state(mesh, state: ParallelState) -> "ParallelState | None":
    """Every rank's part of a process-transport trainer's state, joined
    on rank 0 in rank order (the full state the loopback trainer holds:
    lanes and planes end to end, W and τ rank 0's); None on the other
    ranks.  Every rank of ``mesh`` must call it."""
    from repro_torch.core.messages import gather_parts

    def join(x):
        parts = gather_parts(mesh, x, root=0)
        return None if parts is None else torch.cat(parts)
    zs = tuple(join(z) for z in state.zs)
    u = join(state.u)
    thetas = tuple(join(t) for t in state.thetas)
    if mesh.rank != 0:
        return None
    return ParallelState(state.weights, zs, u, state.taus, thetas)


def serial_state_from_numpy(weights: Sequence[np.ndarray],
                            zs: Sequence[np.ndarray], u: np.ndarray,
                            taus: Sequence, thetas: Sequence,
                            device: "str | torch.device | None" = None
                            ) -> ADMMState:
    """The serial trainer's ``ADMMState`` of f32 tensors: node-row
    (N, C) iterates and dual, τ and θ as 0-dim tensors."""
    return ADMMState(*_leaves(weights, zs, u, taus, thetas, device))


def _model_leaf(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        bits = torch.from_numpy(np.array(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree_from_numpy(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_from_numpy(v, device) for v in tree)
    return _model_leaf(tree, device)


def model_params_from_numpy(tree, device: "str | torch.device | None" = None):
    """The port's parameter tree from the reference's: nested dicts (and
    tuples, lists) mapped key for key, each leaf a tensor of the leaf's
    dtype (bf16 bits kept exactly) on ``device`` (copies, never views of
    the numpy arrays)."""
    return _tree_from_numpy(tree, resolve_device(device))


def model_params_to_rank(tree, model, mesh,
                         device: "str | torch.device | None" = None):
    """This rank's slices of the reference's parameter tree
    (``sharding.partition.place`` by the model's ``param_specs`` on
    ``mesh``), cut on the host and then moved to ``device``: the whole tree
    never reaches the device.  ``partition.gather`` over the ranks gives
    the tree back bit for bit."""
    from repro_torch.sharding import partition
    from repro_torch.util import tree as tree_lib
    device = resolve_device(device)
    local = partition.place(model_params_from_numpy(tree, "cpu"),
                            model.param_specs(mesh), mesh)
    return tree_lib.tree_map(lambda t: t.to(device), local)


# an optimizer state of the reference (``Model.init_optimizer().init``, each
# leaf taken with ``np.asarray``: Adam's {"m", "v", "t"}, SGD's ()) converts
# the same way, structure and dtypes kept
opt_state_from_numpy = model_params_from_numpy


def layerwise_state_from_numpy(state, z0,
                               device: "str | torch.device | None" = None):
    """The reference's ``LayerwiseState`` (each leaf taken with
    ``np.asarray``) and its Z_0 as the port's ``(LayerwiseState, z0)``:
    stack, readout, Z, U, τ, θ and τ_R leaf for leaf, dtypes kept."""
    from repro_torch.core.layerwise import LayerwiseState
    device = resolve_device(device)
    return LayerwiseState(*(_tree_from_numpy(getattr(state, f), device)
                            for f in LayerwiseState._fields)), \
        _model_leaf(z0, device)
