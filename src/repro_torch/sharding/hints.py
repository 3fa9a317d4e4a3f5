"""Activation-sharding hints (src/repro/sharding/hints.py) over rank
processes.

The reference's ``sharding_hints(mesh, moe_a2a=...)`` is a thread-local
context with two readers (``active_mesh``, ``moe_a2a_enabled``); its
``hint_*`` functions pin activations with ``with_sharding_constraint`` and
XLA's SPMD partitioner places every tensor and inserts the collectives.
The port has no partitioner: a rank of a ``launch.mesh.ProcessMesh`` holds
its slices and moves them itself.  So here each hint is a *layout
decision* — a pure function of shapes and the mesh (``shape``,
``axis_names``) under the reference's exact conditions, ``_div`` included
— and ``RankLayout`` materialises the decisions for one rank: which rows of
the batch it holds (``hint_residual``'s batch over the data axes), whether
the residual between layers is its 1/nm of the sequence
(``hint_residual``'s sequence over ``model``), and the ``model``-axis
collectives that enter and leave a split sublayer
(``messages.MeshCollectives``).  The layers read the decisions
(``models.attention``, ``layers``, ``moe``, ``transformer``):

  hint_residual     ``residual_layout``: (B, S, D) batch over the data
                    axes when B divides them, sequence over ``model`` when
                    S % nm == 0 (so a decode step keeps it whole);
  hint_qkv          ``qkv_layout``: ``"heads"`` when Hq and Hkv divide nm,
                    else ``"context"`` (query rows over ``model``, k/v
                    whole) when S divides, else none;
  hint_moe_buffers  ``moe_buffers_layout``: the scatter dispatch's
                    (E·C, D) buffers over ``model``: each rank fills and
                    runs its rows of them (its experts), and the outputs
                    are all-gathered along ``model``;
  hint_tokens       ``tokens_layout``: the flat tokens over the data axes:
                    each data rank routes its share of them.

``moe_token_axes`` is the all-to-all's token groups (moe.py:262-265) and
``a2a_gate`` its gate (moe.py:71-77).  The reference's manual region
(``_manual_axes``: inside a ``shard_map``) is ``manual_region``:
``Model.train_step_deferred`` over ranks runs inside it, manual over the
data axes, as the reference's does.  There the all-to-all is gated off,
the data axes leave every decision (``hint_tokens`` is the identity), the
batch is already this data rank's rows, and ``model`` is still split: the
residual's sequence over ``model`` where nm divides S, the attention by
``qkv_layout``, the MoE buffers over ``model``.  Without a mesh, or with
a one-process mesh, every hint is an identity, as the reference's are.

Gradients over ``model`` (the tensor-parallel training step) follow one
of two conventions, by the layout.  With the residual split
(``seq_split``) every tensor that is the same on every rank carries a
*partial* gradient on each rank, the ranks' parts summing to the whole:
the all-gathers that make such tensors reduce-scatter in the backward
pass, a rank's piece of one is a plain slice, the parameters that are the
same on every rank are summed over ``model`` once a step, and a term of
the loss computed the same on every rank (the MoE's aux loss) keeps its
gradient on the first model rank only (``RankLayout.once``).  With the
residual whole (the families that compute whole, or nm not dividing S)
such tensors carry their *whole* gradient on every rank, as the loss
does: where one enters work split over the ranks its gradient is summed
over ``model`` (``RankLayout.fork``), and an all-gather whose result
every rank then uses alike takes its slice of the gradient.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch

_HINTS: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_hints", default=(None, False, None))
_MANUAL: contextvars.ContextVar = contextvars.ContextVar(
    "manual_axes", default=frozenset())

DATA_AXES = ("pod", "data")


@contextlib.contextmanager
def sharding_hints(mesh, moe_a2a: bool = False, comm=None):
    """Within: ``active_mesh()`` is ``mesh`` and ``moe_a2a_enabled()`` is
    ``moe_a2a`` (the expert-parallel all-to-all dispatch,
    ``moe.apply_moe_a2a``).  Over a ``ProcessMesh`` the ranks' collectives
    are ``comm``, a ``messages.MeshCollectives`` made here when not given
    (yielded: its counters cover the context)."""
    from repro_torch.launch.mesh import ProcessMesh
    if not isinstance(mesh, ProcessMesh):
        comm = None
    elif comm is None:
        from repro_torch.core.messages import MeshCollectives
        comm = MeshCollectives(mesh)
    token = _HINTS.set((mesh, bool(moe_a2a), comm))
    try:
        yield comm
    finally:
        _HINTS.reset(token)


def active_mesh():
    return _HINTS.get()[0]


def moe_a2a_enabled() -> bool:
    return _HINTS.get()[1]


def collectives():
    """The active context's ``MeshCollectives`` (None without ranks)."""
    return _HINTS.get()[2]


@contextlib.contextmanager
def manual_region(axes):
    """Within: ``axes`` are manual (the reference's ``shard_map`` region,
    e.g. its deferred train step, manual over the data axes)."""
    token = _MANUAL.set(_MANUAL.get() | frozenset(axes))
    try:
        yield
    finally:
        _MANUAL.reset(token)


def manual_axes() -> frozenset:
    return _MANUAL.get()


def inside_manual_region() -> bool:
    return bool(_MANUAL.get())


# ---------------------------------------------------------------------------
# layout decisions: the reference's conditions, as functions of shapes
# ---------------------------------------------------------------------------

def _div(dim: int, mesh, axes) -> bool:
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total > 0 and dim % total == 0 and dim >= total


def _dp_axes(mesh) -> tuple[str, ...]:
    manual = manual_axes()
    return tuple(a for a in mesh.axis_names
                 if a in DATA_AXES and a not in manual)


def data_ranks(mesh) -> int:
    """The product of the data axes that are not manual here."""
    return math.prod(mesh.shape[a] for a in _dp_axes(mesh))


def dp_size(mesh) -> int:
    """The reference's ``_dp_size``: the data axes' product."""
    return math.prod(mesh.shape[a] for a in DATA_AXES
                     if a in mesh.axis_names)


def residual_layout(shape, mesh):
    """``hint_residual`` of an activation of ``shape``: (batch axes or
    None, ``"model"`` or None) for a (B, S, D) one, None where the
    reference leaves it alone (no mesh, not 3-D, or neither applies)."""
    if mesh is None or len(shape) != 3:
        return None
    dp = _dp_axes(mesh)
    bspec = dp if dp and _div(shape[0], mesh, dp) else None
    seq = "model" if ("model" in mesh.axis_names
                      and "model" not in manual_axes()
                      and shape[1] % mesh.shape["model"] == 0) else None
    if bspec is None and seq is None:
        return None
    return bspec, seq


def qkv_layout(q_shape, k_shape, mesh):
    """``hint_qkv`` of q (B, S, Hq, hd) and k (B, S, Hkv, hd): (``"heads"``,
    ``"context"`` or None, batch axes or None)."""
    if mesh is None or "model" not in mesh.axis_names \
            or "model" in manual_axes():
        return None, None
    msz = mesh.shape["model"]
    dp = _dp_axes(mesh)
    bq = dp if dp and _div(q_shape[0], mesh, dp) else None
    if q_shape[2] % msz == 0 and k_shape[2] % msz == 0:
        return "heads", bq
    if q_shape[1] % msz == 0:
        return "context", bq
    return None, bq


def moe_buffers_layout(rows: int, mesh) -> bool:
    """``hint_moe_buffers`` of the (E·C, D) dispatch and return buffers
    (one shape here): True when their ``rows`` go over ``model``."""
    if mesh is None or "model" not in mesh.axis_names \
            or "model" in manual_axes():
        return False
    return rows % mesh.shape["model"] == 0


def tokens_layout(shape, mesh):
    """``hint_tokens`` of flat tokens (T, D): the data axes, or None."""
    if mesh is None:
        return None
    dp = _dp_axes(mesh)
    if not dp or not _div(shape[0], mesh, dp):
        return None
    return dp


def moe_token_axes(tokens: int, mesh) -> tuple[str, ...]:
    """The axes ``apply_moe_a2a`` cuts the flat tokens over (moe.py:
    262-265): the data axes and ``model`` when they divide the count, else
    the data axes when those do, else none (one group)."""
    dp = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    nm = mesh.shape["model"]
    if tokens % (dp_size(mesh) * nm) == 0:
        return dp + ("model",)
    if tokens % dp_size(mesh) == 0:
        return dp
    return ()


def a2a_gate(cfg, mesh) -> bool:
    """The reference's gate (moe.py:71-77) past ``moe_a2a_enabled``: the
    mesh has ``model``, E % nm == 0 and E ≥ nm, outside a manual
    region."""
    if mesh is None or "model" not in mesh.axis_names \
            or inside_manual_region():
        return False
    nm = mesh.shape["model"]
    e = cfg.moe.num_experts
    return e % nm == 0 and e >= nm


# ---------------------------------------------------------------------------
# one rank's materialisation of the decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankLayout:
    """Where this rank's activations of a (``batch``, ``seq``) call lie:
    ``rows`` of the global batch (all of them when the data axes do not
    divide it, or inside the data-manual region, where ``batch`` is this
    data rank's), and the residual between layers either whole along
    ``model`` or (``seq_split``) positions ``positions`` of the sequence.
    ``comm`` moves them along ``model``; its gradients follow the module's
    two conventions, by ``seq_split``."""
    mesh: object
    comm: object
    batch: int
    seq: int
    rows: slice
    seq_split: bool

    @property
    def nm(self) -> int:
        return self.mesh.shape["model"]

    @property
    def m(self) -> int:
        return self.comm.model.rank

    @property
    def positions(self) -> slice:
        if not self.seq_split:
            return slice(0, self.seq)
        n = self.seq // self.nm
        return slice(self.m * n, (self.m + 1) * n)

    def piece(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of a data-local (B, S, ...) tensor."""
        return x[:, self.positions] if self.seq_split else x

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces of ``x`` all-gathered along ``model`` into a
        tensor the same on every rank: its gradient by the convention
        (summed and cut where the residual is split, else this rank's
        slice)."""
        return self.comm.gather_model(
            x, dim, "scatter" if self.seq_split else "slice")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual ``x`` whole along ``model``, for work split over
        the ranks (an all-gather of the sequence pieces when it is split;
        else ``x``, its gradient summed over ``model``)."""
        return self.join(x, 1) if self.seq_split else self.comm.fork_model(x)

    def fork(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the same on every rank, for work split over the ranks:
        with the residual whole its gradient is summed over ``model``."""
        return x if self.seq_split else self.comm.fork_model(x)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """A loss term computed the same on every rank: with the residual
        split its gradient stays on the first model rank only."""
        return self.comm.first_rank_grad(x) if self.seq_split else x

    def whole(self, w: torch.Tensor, dim: int, full: int,
              back: str = "scatter") -> torch.Tensor:
        """A weight all-gathered along ``model`` where it is split there
        (its ``dim`` short of ``full``); ``back`` as ``gather_model``'s:
        ``"scatter"`` where the ranks then use it on their own parts of
        the work (a weight already whole is then ``fork``ed), ``"slice"``
        where every rank uses it alike."""
        if w.shape[dim] == full:
            return self.fork(w) if back == "scatter" else w
        return self.comm.gather_model(w, dim, back)

    def leave(self, partial: torch.Tensor) -> torch.Tensor:
        """Σ over ``model`` of a split sublayer's partial outputs (B, S, D),
        in rank order, laid out as the residual: reduce-scattered into the
        sequence pieces when split, else whole on every rank."""
        if self.seq_split:
            return self.comm.reduce_scatter_model(partial, 1)
        return self.comm.sum_model(partial)


def ranks_active() -> bool:
    """Whether the hints hold a ``ProcessMesh`` whose ``model`` axis is
    not manual: tensors are then this rank's slices."""
    from repro_torch.launch.mesh import ProcessMesh
    return isinstance(active_mesh(), ProcessMesh) and \
        "model" not in manual_axes()


def rank_layout(batch: int, seq: int) -> Optional[RankLayout]:
    """The active hints' layout of a (``batch``, ``seq``) call on this
    rank, or None where nothing is split: no hints, a one-process mesh, or
    ``model`` manual.  Inside the data-manual region ``batch`` is this
    data rank's rows, all of them local."""
    if not ranks_active():
        return None
    mesh, comm = active_mesh(), collectives()
    lay = residual_layout((batch, seq, 1), mesh)
    bspec, seq_axis = lay if lay is not None else (None, None)
    rows = slice(0, batch)
    if bspec is not None:
        dp = comm.data
        n = batch // dp.world_size
        rows = slice(dp.rank * n, (dp.rank + 1) * n)
    return RankLayout(mesh, comm, batch, seq, rows,
                      seq_axis is not None and mesh.shape["model"] > 1)
