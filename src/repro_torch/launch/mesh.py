"""The devices the training launchers run on (src/repro/launch/mesh.py).

The reference builds TPU meshes of ``data`` × ``model`` axes.  The port
has two: ``HostMesh``, one device (the card, or the CPU when asked for)
that a single process drives — a language-model launcher's mesh, and the
GCN trainer's when its shards are logical shards of one device (the
loopback transport) — and ``ProcessMesh``, one rank of a
``torch.distributed`` group, one process per GCN agent shard (the process
transport).  Both keep the reference's axis names, so a launcher prints the
same ``mesh=`` line and ``data_axes`` works as there.  A ``data`` ×
``model`` mesh of many devices for the language models is ROADMAP queue A
item 5.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time

import torch

from repro_torch.util.device import rank_device, resolve_device

_MULTI_DEVICE = ("a production mesh of many devices is ROADMAP queue A "
                 "item 5 (the process transport)")
# a collective that never completes fails after this long instead of hanging
DEFAULT_TIMEOUT_S = 60.0
MAX_TIMEOUT_S = 120.0


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


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a ``torch.distributed`` group: one rank per
    shard of the reference's ``data`` axis (size = world size).  ``group``
    is the process group every collective of the transport goes through."""
    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: object
    axis_names: tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.world_size}

    @property
    def size(self) -> int:
        return self.world_size


def check_backend(backend: str, world_size: int,
                  device: "str | torch.device | None") -> None:
    """Refuse a backend that cannot run this group, naming the one that
    can: NCCL needs one card per rank (it refuses two ranks on one card)
    and never runs on the CPU."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected 'nccl' or "
                         f"'gloo'")
    if backend != "nccl":
        return
    if device is not None and torch.device(device).type == "cpu":
        raise ValueError("backend 'nccl' runs on CUDA devices only; pass "
                         "--backend gloo to run the ranks on the CPU")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > cards:
        raise ValueError(f"backend 'nccl' needs one card per rank: "
                         f"{world_size} ranks over {cards} card(s); pass "
                         f"--backend gloo to share a card (or the CPU)")


def init_process_mesh(rank: int, world_size: int, backend: str,
                      store_path: str,
                      device: "str | torch.device | None" = None,
                      timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """Join the group of ``world_size`` ranks as ``rank`` through a file
    store at ``store_path`` (``file://``; no network port), with a finite
    collective ``timeout`` in seconds (at most 120).  ``device`` as in
    ``rank_device``: ``None`` is the card, ``"cpu"`` the CPU."""
    check_backend(backend, world_size, device)
    if not 0 < timeout <= MAX_TIMEOUT_S:
        raise ValueError(f"timeout must be in (0, {MAX_TIMEOUT_S:g}] s, "
                         f"got {timeout!r}")
    import torch.distributed as dist
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    group = dist.group.WORLD
    # every rank in one collective before the first point-to-point round
    dist.barrier(group=group)
    return ProcessMesh(rank, world_size, backend, dev, group)


def destroy(mesh: ProcessMesh) -> None:
    """Leave the group (every rank calls it once, at the end)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (),
              timeout: float = 900.0) -> None:
    """Run ``fn(rank, store_path, *args)`` in ``world_size`` new processes
    (the spawn start method: a forked child of a process that has
    initialised CUDA cannot use it), ``store_path`` a file store in a
    temporary directory.  Raises if any rank raises or exits nonzero (the
    others are then stopped), or if the ranks outlive ``timeout`` seconds
    (then every rank is killed)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(fn, args=(store,) + tuple(args),
                                 nprocs=world_size, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running "
                                       f"after {timeout:g} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    raise NotImplementedError(_MULTI_DEVICE)


def make_host_mesh(device: "str | torch.device | None" = None) -> HostMesh:
    """One device: the card unless ``device`` says otherwise."""
    return HostMesh((resolve_device(device),))


def data_axes(mesh: "HostMesh | ProcessMesh") -> tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
