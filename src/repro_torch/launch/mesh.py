"""The devices the training launchers run on (src/repro/launch/mesh.py).

The reference builds TPU meshes of ``data`` × ``model`` axes.  The port
has two kinds: ``HostMesh``, one device (the card, or the CPU when asked
for) that a single process drives — a language-model launcher's mesh, and
the GCN trainer's when its shards are logical shards of one device (the
loopback transport) — and ``ProcessMesh``, one rank of a
``torch.distributed`` group.  A ``ProcessMesh`` is 1-D (``data``, one rank
per GCN agent shard: the process transport) or the reference's
``data`` × ``model`` (``pod`` × ``data`` × ``model`` for ``multi_pod``)
mesh of ranks for the language models, with ranks laid out row-major as
``jax.make_mesh`` orders devices and one sub-group per axis
(``ProcessMesh.axis``).  All keep the reference's ``shape`` /
``axis_names``, so a launcher prints the same ``mesh=`` line and
``data_axes`` and the spec rules of ``sharding.partition`` read them
unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile
import time

import torch

from repro_torch.util.device import rank_device, resolve_device

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
class AxisGroup:
    """The ranks of one axis (or of several, e.g. the data axes) that share
    this rank's other coordinates, in mesh order: ``rank`` is this
    process's index among them, ``ranks`` their global ranks, ``group``
    their sub-group (None for one rank).  It carries the fields
    ``messages.gather_parts`` reads, so the collectives of the transport
    run over it as over a whole mesh."""
    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: object
    ranks: tuple[int, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This process's place in a ``torch.distributed`` group.  One-D (the
    default): one rank per shard of the reference's ``data`` axis (size =
    world size).  With ``dims``: the ranks laid out row-major over
    ``axis_names`` (``data`` × ``model``, or ``pod`` × ``data`` ×
    ``model``), ``axes`` holding this rank's sub-group of each axis and of
    the data axes together.  ``group`` is the whole group."""
    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: object
    axis_names: tuple[str, ...] = ("data",)
    dims: tuple[int, ...] = ()
    axes: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims or (self.world_size,)))

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major)."""
        return _coords(self.rank, self.axis_names,
                       self.dims or (self.world_size,))

    def axis(self, *names: str) -> AxisGroup:
        """The sub-group over ``names`` (one axis, or the data axes
        together) that holds this rank; a one-rank group for an axis of
        size 1 or one the mesh lacks."""
        names = tuple(n for n in names if n in self.axis_names)
        if not names:
            return AxisGroup(0, 1, self.backend, self.device, None,
                             (self.rank,))
        if not self.dims and names == self.axis_names:
            return AxisGroup(self.rank, self.world_size, self.backend,
                             self.device, self.group,
                             tuple(range(self.world_size)))
        return self.axes[names]


def _coords(rank: int, names, dims) -> dict[str, int]:
    out, rest = {}, rank
    for name, size in zip(reversed(names), reversed(dims)):
        rest, out[name] = divmod(rest, size)
    return {n: out[n] for n in names}


def _axis_groups(rank: int, backend: str, device: torch.device,
                 names: tuple[str, ...], dims: tuple[int, ...]) -> dict:
    """Every rank's sub-groups of each axis and of the data axes together:
    ``dist.new_group`` is called by every rank for every group, in one
    order; a group of one rank gets no process group."""
    import torch.distributed as dist
    world = math.prod(dims)
    sets = [(n,) for n in names]
    dp = tuple(n for n in names if n in ("pod", "data"))
    if len(dp) > 1:
        sets.append(dp)
    out = {}
    for axes in sets:
        buckets: dict = {}
        for r in range(world):
            c = _coords(r, names, dims)
            key = tuple(c[n] for n in names if n not in axes)
            buckets.setdefault(key, []).append(r)
        for key in sorted(buckets):
            ranks = tuple(buckets[key])
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                out[axes] = AxisGroup(ranks.index(rank), len(ranks), backend,
                                      device, group, ranks)
    return out


def _grid_mesh(base: "ProcessMesh", names: tuple[str, ...],
               dims: tuple[int, ...]) -> "ProcessMesh":
    if math.prod(dims) != base.world_size:
        raise ValueError(f"a {' x '.join(map(str, dims))} mesh needs "
                         f"{math.prod(dims)} ranks; the group has "
                         f"{base.world_size}")
    return ProcessMesh(base.rank, base.world_size, base.backend, base.device,
                       base.group, names, dims,
                       _axis_groups(base.rank, base.backend, base.device,
                                    names, dims))


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


PRODUCTION_SHAPES = {False: (("data", "model"), (16, 16)),
                     True: (("pod", "data", "model"), (2, 16, 16))}


def make_production_mesh(*, multi_pod: bool = False,
                         backend: "str | None" = None) -> ProcessMesh:
    """The reference's production mesh, 16 × 16 (``multi_pod``: 2 × 16 ×
    16), over a world of 256 (512) ranks that a launcher such as
    ``torchrun`` started: the group is joined through the environment it
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), each rank on card ``LOCAL_RANK``.  Any other world
    size is refused before anything is joined.  ``backend`` defaults to
    NCCL (gloo without a card)."""
    names, dims = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(dims)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(f"the production mesh {' x '.join(map(str, dims))} "
                         f"needs a world of {need} ranks; this world has "
                         f"{world} (WORLD_SIZE); start {need} ranks with "
                         f"torchrun, or use make_rank_mesh on a smaller "
                         f"group")
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    dev = resolve_device(f"cuda:{local % torch.cuda.device_count()}"
                         if cuda else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DEFAULT_TIMEOUT_S))
    base = ProcessMesh(rank, world, backend, dev, dist.group.WORLD)
    return _grid_mesh(base, names, dims)


@contextlib.contextmanager
def stand_in_mesh(dims: tuple[int, ...], rank: int = 0,
                  device: "str | torch.device" = "meta"):
    """Rank ``rank`` of a ``data`` × ``model`` (``pod`` × ``data`` ×
    ``model`` for three ``dims``) mesh whose other ranks do not exist:
    torch's fake process group, whose collectives return at once and
    leave their outputs as they are (on ``meta`` tensors, nothing to
    leave).  The axes, sub-groups and coordinates are the real ones
    (``_grid_mesh``), so ``MeshCollectives`` counts what a rank of a real
    mesh would send.  Refused in a process that is already in a group;
    the group is destroyed on the way out."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a stand-in mesh needs a process with no "
                           "default process group; this one is in a group")
    names = ("pod", "data", "model")[-len(dims):]
    world = math.prod(dims)
    if len(dims) not in (2, 3) or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a {' x '.join(map(str, dims))} "
                         f"mesh: dims are (data, model) or (pod, data, "
                         f"model), and 0 <= rank < {world}")
    # registers the "fake" backend
    from torch.testing._internal.distributed import fake_pg
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=world)
    try:
        base = ProcessMesh(rank, world, "fake", torch.device(device),
                           dist.group.WORLD)
        yield _grid_mesh(base, names, tuple(dims))
    finally:
        dist.destroy_process_group()


def make_rank_mesh(mesh: ProcessMesh, model_axis: int = 1) -> ProcessMesh:
    """The counterpart of the reference's ``make_host_mesh(model_axis)``
    over the ranks of a joined group: ``data`` = world // ``model_axis``
    by ``model``.  Every rank of ``mesh`` calls it, with the same
    ``model_axis`` (it makes each axis's sub-groups)."""
    if model_axis < 1 or mesh.world_size % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"group's {mesh.world_size} ranks")
    return _grid_mesh(mesh, ("data", "model"),
                      (mesh.world_size // model_axis, model_axis))


def make_host_mesh(device: "str | torch.device | None" = None) -> HostMesh:
    """One device: the card unless ``device`` says otherwise."""
    return HostMesh((resolve_device(device),))


def data_axes(mesh: "HostMesh | ProcessMesh") -> tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_rows(mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that this rank holds: the
    leading dim cut evenly over the data axes (where ``batch_specs`` puts
    it), in mesh order.  All of it without a mesh of ranks."""
    if not isinstance(mesh, ProcessMesh):
        return slice(0, n)
    dp = mesh.axis(*data_axes(mesh))
    if n % dp.world_size:
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"{dp.world_size} data ranks")
    k = n // dp.world_size
    return slice(dp.rank * k, (dp.rank + 1) * k)
