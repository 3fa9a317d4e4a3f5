"""The devices the training launcher runs on (src/repro/launch/mesh.py).

The reference builds TPU meshes of ``data`` × ``model`` axes.  The port
trains on one device: the card, or the CPU when asked for.  ``HostMesh``
keeps the reference's axis names and sizes (all 1), so a launcher prints
the same ``mesh=`` line and ``data_axes`` works as there.  A mesh of many
devices (one process per card) is ROADMAP queue A item 5.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.util.device import resolve_device

_MULTI_DEVICE = ("a production mesh of many devices is ROADMAP queue A "
                 "item 5 (the process transport)")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    raise NotImplementedError(_MULTI_DEVICE)


def make_host_mesh(device: "str | torch.device | None" = None) -> HostMesh:
    """One device: the card unless ``device`` says otherwise."""
    return HostMesh((resolve_device(device),))


def data_axes(mesh: HostMesh) -> tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
