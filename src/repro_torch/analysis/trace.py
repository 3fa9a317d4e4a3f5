"""The port's tracing: an op trace for the rules, a span log for timing.

**The op trace** is the program form the port's rules read, the
counterpart of ``repro.analysis.hlo``.  The reference lints the HLO text
XLA compiles for a jitted step.  The port runs eagerly, so its rules read
a trace recorded while one real step runs.  It has two parts:

  * every aten op, logged by a ``TorchDispatchMode``: its name, the id,
    shape, dtype and device of each input and output tensor, whether it
    writes in place, and — for a host read — the line-search probe site
    that asked for it (``decide``);
  * events that the port's own code emits for what the dispatcher cannot
    see: each hand-written kernel launch (through ``ctypes``; on the CPU the
    plain version that stands in for it), with its launch spec and its
    index tables; each loopback transport round (source → destination
    pairs, rows, bytes) and the all-gather; and the shard-ordered sum that
    stands for the reference's W-update psum.

``torch.fx`` and ``torch.export`` cannot hold the step: every line-search
probe reads a bool on the host, and that data-dependent control flow stops
both.  The profiler's kernel trace sees kernels only on a card, and
carries no dtypes for the f32-accumulation checks.  A dispatch trace
behaves the same on the CPU and on the card, and sees the backward passes
the line searches run.  ``with record() as tape: tr.step()``.  It holds no
tensor but the kernels' index tables, copies none and reads no value from
the device: tensors are known by an id (a weak map from tensor to int), so
nothing it keeps outlives the step.

**The span log** times the parts of the trainer on the host: ``with
spans() as log: tr.step()``.  Each span is a named interval on
``time.perf_counter_ns`` with the index of the span around it, the id of
the ``admm.step`` it lies in and small attributes (the layer ``l``, the
probe ``site``), kept in columns of Python lists; counters count by name
(``host_reads.<site>``: one a device → host read, made in ``decide`` and
under ``marked``; ``fista.kernel`` / ``fista.plain``: the route a step's
Z_L prox took, through ``count``).  No ``record_function``, CUDA event or
device read is made, and no tensor is kept.  ``log.anchor`` pairs the clock
with ``time.time_ns``, the wall clock torch.profiler measures its events
from, so that a profiled window's device timeline can be laid under the
spans.
``SpanLog.summary`` reduces a log by span name.

Both are off by default.  The hooks in the port (``RECORDER is not
None``, ``span``, ``decide``, ``marked``, ``count``) cost a
module-attribute check when they are off; ``span`` then returns one shared
null context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Iterable, Iterator, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

RECORDER: "Optional[Recorder]" = None
SPANS: "Optional[SpanLog]" = None

# aten ops that multiply matrices: the consumers the product rules watch
PRODUCT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                         "addmv", "dot", "vdot", "_scaled_mm",
                         "convolution", "_convolution"})
# reductions whose accumulator the precision rules watch
REDUCE_OPS = frozenset({"sum", "mean", "cumsum", "prod", "nansum",
                        "linalg_vector_norm", "norm", "var", "std"})
TRANSPORTS = ("exchange", "exchange_packed", "allgather")


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """A tensor as the trace knows it: an id unique within the trace, its
    shape, dtype (``"float32"``) and device type."""
    id: int
    shape: tuple[int, ...]
    dtype: str
    device: str

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE.get(self.dtype, 4)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


_ITEMSIZE = {"float64": 8, "complex128": 16, "int64": 8, "float32": 4,
             "int32": 4, "complex64": 8, "bfloat16": 2, "float16": 2,
             "int16": 2, "int8": 1, "uint8": 1, "bool": 1}


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded event.

    ``kind`` is ``"op"`` (an aten op; ``name`` the op without its overload,
    e.g. ``"mm"``), ``"kernel"`` (``name`` the kernel, ``info`` its
    ``spec``, ``route`` "cuda" or "plain" and ``tables``), a transport
    (``"exchange"``, ``"exchange_packed"``, ``"allgather"``; ``info`` the
    ``rounds``: one ``(pairs, rows, bytes)`` per round, and the
    ``itemsize`` on the wire) or ``"shard_sum"``.  ``host_read`` marks a
    device → host read, ``probe`` the line-search site it decides."""
    kind: str
    name: str
    inputs: tuple[TensorMeta, ...] = ()
    outputs: tuple[TensorMeta, ...] = ()
    inplace: bool = False
    host_read: bool = False
    probe: Optional[str] = None
    info: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Census:
    """Totals of a trace: aten ops, product FLOPs (aten products and
    kernels), an HBM-traffic proxy (each op's and kernel's input and output
    bytes), and the transport bytes per kind with their round counts."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: {"count": 0, "bytes": 0.0}
                                 for k in TRANSPORTS + ("shard_sum",)})
    ops: int = 0


@dataclasses.dataclass
class Trace:
    """The events of one recorded run, in order."""
    events: list[Event] = dataclasses.field(default_factory=list)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def of_kind(self, *kinds: str) -> list[Event]:
        return [e for e in self.events if e.kind in kinds]

    def produced(self) -> set[int]:
        """Ids of the tensors some recorded event made (not inputs)."""
        out: set[int] = set()
        for e in self.events:
            if not e.inplace:
                out.update(t.id for t in e.outputs)
        return out

    def tensors(self) -> dict[int, TensorMeta]:
        """Every tensor the trace saw, by id."""
        out: dict[int, TensorMeta] = {}
        for e in self.events:
            for t in e.inputs + e.outputs:
                out.setdefault(t.id, t)
        return out


def trace_census(tr: Trace) -> Census:
    """The census of a trace (the reference's ``hlo_census`` counterpart):
    2·M·N·K for every aten product, each kernel's spec FLOPs (every slot at
    full rows), each op's and kernel's bytes, and the transport bytes."""
    c = Census()
    for e in tr.events:
        if e.kind == "op":
            c.ops += 1
            c.hbm_bytes += sum(t.nbytes for t in e.inputs + e.outputs)
            if e.name in PRODUCT_OPS:
                c.flops += _product_flops(e)
        elif e.kind == "kernel":
            spec = e.info.get("spec")
            if spec is not None:
                c.flops += spec.flops
            c.hbm_bytes += sum(t.nbytes for t in e.inputs + e.outputs)
        else:
            nbytes = sum(r[2] for r in e.info.get("rounds", ()))
            if e.kind == "shard_sum":
                nbytes = sum(t.nbytes for t in e.inputs)
            c.collectives[e.kind]["count"] += max(
                len(e.info.get("rounds", ())), 1)
            c.collectives[e.kind]["bytes"] += nbytes
            if e.kind in TRANSPORTS:
                c.collective_bytes += nbytes
    return c


def _product_flops(e: Event) -> float:
    """2 per multiply-add: the output's elements times the contracted
    extent (a matrix operand's rows, a matrix-vector product's columns, a
    convolution weight's elements per output channel)."""
    shapes = [t.shape for t in e.inputs if t.shape]
    if e.name in ("dot", "vdot"):
        return 2.0 * shapes[0][0]
    out = math.prod(e.outputs[0].shape)
    if e.name in ("convolution", "_convolution"):
        return 2.0 * out * math.prod(shapes[1][1:])
    mats = [s for s in shapes if len(s) >= 2]
    k = mats[-1][-1] if e.name in ("mv", "addmv") else mats[-1][-2]
    return 2.0 * out * k


def tensors_in(x) -> Iterator[torch.Tensor]:
    """The tensors in ``x``, a tensor or nested tuples, lists and dicts
    of them (an op's arguments and outputs), in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from tensors_in(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from tensors_in(y)


class Recorder:
    """Collects a ``Trace``.  Use ``record()``; the port's hooks call
    ``kernel``, ``transport`` and ``shard_sum`` while it is active."""

    def __init__(self):
        self.trace = Trace()
        self._ids = WeakIdKeyDictionary()
        self._next = 0
        self.probe_site: Optional[str] = None

    # -- tensor identity ---------------------------------------------------

    def meta(self, t: torch.Tensor) -> TensorMeta:
        i = self._ids.get(t)
        if i is None:
            i = self._ids[t] = self._next
            self._next += 1
        return TensorMeta(i, tuple(t.shape), str(t.dtype).split(".")[-1],
                          t.device.type)

    def metas(self, xs: Iterable[Any]) -> tuple[TensorMeta, ...]:
        return tuple(self.meta(x) for x in tensors_in(list(xs)))

    # -- events --------------------------------------------------------------

    def op(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        schema = func._schema
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        ins = self.metas([args, kwargs])
        outs = self.metas([out])
        host = name == "_local_scalar_dense" or (
            name in ("_to_copy", "copy_", "to") and outs and ins
            and outs[0].device == "cpu" and ins[-1].device != "cpu")
        self.trace.events.append(Event(
            "op", name, ins, outs, inplace=inplace, host_read=host,
            probe=self.probe_site if host else None))

    def kernel(self, spec, tensors: Mapping[str, torch.Tensor],
               route: str) -> None:
        """A kernel launch (``route="cuda"``) or the plain version that
        stands in for it on the CPU (``route="plain"``): ``tensors`` by the
        spec's operand names, the output last."""
        names = [a.name for a in spec.args]
        ins = [tensors[n] for n in names if n != "out"]
        self.trace.events.append(Event(
            "kernel", spec.name, self.metas(ins),
            self.metas([tensors["out"]]),
            info={"spec": spec, "route": route,
                  "tables": {n: tensors[n] for n in spec.table_names}}))

    def transport(self, kind: str, x: torch.Tensor, out, rounds,
                  itemsize: int) -> None:
        """A transport call: ``rounds`` one ``(pairs, rows, bytes)`` each."""
        self.trace.events.append(Event(
            kind, kind, self.metas([x]), self.metas([out]),
            info={"rounds": tuple(rounds), "itemsize": itemsize}))

    def shard_sum(self, parts, out) -> None:
        self.trace.events.append(Event(
            "shard_sum", "shard_sum", self.metas(parts), self.metas([out])))


class _Mode(TorchDispatchMode):
    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rec.op(func, args, kwargs, out)
        return out


class record:
    """``with record() as tape:`` — every aten op and port event inside
    lands in ``tape`` (a ``Trace``).  Not reentrant."""

    def __enter__(self) -> Trace:
        global RECORDER
        if RECORDER is not None:
            raise RuntimeError("a trace is already being recorded")
        self._rec = RECORDER = Recorder()
        self._mode = _Mode(self._rec)
        self._mode.__enter__()
        return self._rec.trace

    def __exit__(self, *exc) -> None:
        global RECORDER
        try:
            self._mode.__exit__(*exc)
        finally:
            RECORDER = None


class marked:
    """``with marked(site):`` — the host reads inside are made on purpose
    and carry ``site`` in the trace, so that ``memory/host-transfer`` can
    tell them from any other read: a line-search decision (``decide``),
    and on the process transport the host staging of a gloo round and the
    per-step count of the bytes sent.  In a span log the region is a
    ``host.read`` span (the host waits on the card there) and counts
    ``reads`` under ``host_reads.<site>``."""

    def __init__(self, site: str, reads: int = 1):
        self.site, self.reads = site, reads

    def __enter__(self) -> None:
        self._rec = rec = RECORDER
        if rec is not None:
            self._prev, rec.probe_site = rec.probe_site, self.site
        self._log = log = SPANS
        if log is not None:
            log.count("host_reads." + self.site, self.reads)
            log.open("host.read", time.perf_counter_ns(), site=self.site)

    def __exit__(self, *exc) -> None:
        if self._log is not None:
            self._log.close(time.perf_counter_ns())
        if self._rec is not None:
            self._rec.probe_site = self._prev


def decide(flag: torch.Tensor, site: str) -> bool:
    """``bool(flag)``: a line-search decision, the host read a step makes
    on purpose.  Under a recorder or a span log the read is ``marked``
    with ``site``."""
    if RECORDER is None and SPANS is None:
        return bool(flag)
    with marked(site):
        return bool(flag)


# ---------------------------------------------------------------------------
# the span log
# ---------------------------------------------------------------------------

# the root span of one trainer step: every span inside it carries its id
STEP = "admm.step"
_NULL = contextlib.nullcontext()


class SpanLog:
    """The spans and counters of ``with spans() as log:``.

    One entry a span in each column, in the order the spans opened:
    ``names``; ``start_ns`` and ``end_ns`` on ``time.perf_counter_ns``
    (-1 while open); ``parents``, the index of the span open around it
    (-1 for none); ``steps``, the id of the ``admm.step`` span it lies in
    (0, 1, … in the log's order; -1 outside a step); ``layers`` and
    ``sites``, its attributes (None where not given).  ``counts`` maps a
    counter's name to its total.  ``anchor`` is ``(perf_counter_ns,
    time_ns)`` read together when the log opened: ``wall_ns`` maps a span's
    time onto the wall clock."""

    def __init__(self):
        self.names: list[str] = []
        self.start_ns: list[int] = []
        self.end_ns: list[int] = []
        self.parents: list[int] = []
        self.steps: list[int] = []
        self.layers: list[Optional[int]] = []
        self.sites: list[Optional[str]] = []
        self.counts: dict[str, int] = {}
        self.n_steps = 0
        self._open = -1
        self._step = -1
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.closer = _Closer(self)

    def __len__(self) -> int:
        return len(self.names)

    def open(self, name: str, t_ns: int, l: Optional[int] = None,
             site: Optional[str] = None) -> None:
        """Open a span at ``t_ns`` inside the innermost open one."""
        i = len(self.names)
        if name == STEP:
            self._step, self.n_steps = self.n_steps, self.n_steps + 1
        self.names.append(name)
        self.start_ns.append(t_ns)
        self.end_ns.append(-1)
        self.parents.append(self._open)
        self.steps.append(self._step)
        self.layers.append(l)
        self.sites.append(site)
        self._open = i

    def close(self, t_ns: int) -> None:
        """Close the innermost open span at ``t_ns``."""
        i = self._open
        if i < 0:
            return
        self.end_ns[i] = t_ns
        self._open = p = self.parents[i]
        self._step = self.steps[p] if p >= 0 else -1

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def total(self, prefix: str) -> int:
        """The sum of the counters ``prefix`` and ``prefix.<anything>``
        (``total("host_reads")``: every site's reads)."""
        return sum(v for k, v in self.counts.items()
                   if k == prefix or k.startswith(prefix + "."))

    def wall_ns(self, t_ns: int) -> int:
        """``t_ns`` of ``perf_counter_ns`` on ``time_ns``'s clock."""
        return t_ns - self.anchor[0] + self.anchor[1]

    def self_ns(self) -> list[int]:
        """Each closed span's own time: its length less its closed
        children's (-1 for a span still open)."""
        length = [e - s if e >= 0 else -1
                  for s, e in zip(self.start_ns, self.end_ns)]
        own = list(length)
        for i, p in enumerate(self.parents):
            if p >= 0 and length[i] >= 0 and length[p] >= 0:
                own[p] -= length[i]
        return own

    def summary(self, steps: "Optional[Iterable[int]]" = None) -> dict:
        """Per span name, over the closed spans (of the steps ``steps``,
        default every span): ``count``, ``host_s`` (their summed length)
        and ``self_s`` (their own time, ``self_ns``), in the order the
        names first appear."""
        keep = None if steps is None else set(steps)
        own = self.self_ns()
        out: dict[str, dict] = {}
        for i, name in enumerate(self.names):
            if own[i] < 0 or (keep is not None and self.steps[i] not in keep):
                continue
            row = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                        "self_s": 0.0})
            row["count"] += 1
            row["host_s"] += (self.end_ns[i] - self.start_ns[i]) * 1e-9
            row["self_s"] += own[i] * 1e-9
        return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open span log's counter ``name``; nothing without
    a log."""
    if SPANS is not None:
        SPANS.count(name, n)


class _Closer:
    """The context ``span`` returns while a log is on: the span opened in
    ``span``; leaving the block closes it."""

    def __init__(self, log: SpanLog):
        self.log = log

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        self.log.close(time.perf_counter_ns())


def span(name: str, l: Optional[int] = None, site: Optional[str] = None):
    """``with span(name):`` — the block is one span of the open log, with
    the layer ``l`` and probe ``site`` as attributes.  Without a log, one
    shared null context."""
    log = SPANS
    if log is None:
        return _NULL
    log.open(name, time.perf_counter_ns(), l, site)
    return log.closer


class spans:
    """``with spans() as log:`` — the port's spans and counters inside land
    in ``log`` (a ``SpanLog``; pass ``log`` to go on in an earlier one).
    Not reentrant."""

    def __init__(self, log: "Optional[SpanLog]" = None):
        self._log = log

    def __enter__(self) -> SpanLog:
        global SPANS
        if SPANS is not None:
            raise RuntimeError("a span log is already open")
        if self._log is None:
            self._log = SpanLog()
        SPANS = self._log
        return self._log

    def __exit__(self, *exc) -> None:
        global SPANS
        SPANS = None
