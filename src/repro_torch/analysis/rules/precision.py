"""Precision rules: bf16 stays on the wire and in storage, never in an
accumulator.

The port's counterparts of ``repro.analysis.rules.precision``.  bf16 is a
transport and storage format (the bf16 wire, bf16 ELL blocks) while every
product and reduction accumulates in f32.  The trace shows each aten op's
operand and result dtypes; a kernel event declares its accumulation dtype
in its launch spec.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import AnalysisContext, rule
from repro_torch.analysis.trace import PRODUCT_OPS, REDUCE_OPS, Event

LOW = ("bfloat16", "float16")
WIDE = ("float64", "complex128")


def _low(e: Event) -> list[str]:
    return [t.dtype for t in e.inputs if t.dtype in LOW]


def _accumulates_low(e: Event) -> bool:
    """A product or kernel over low-precision operands whose sum is kept
    in low precision."""
    if not _low(e):
        return False
    if e.kind == "kernel":
        return e.info["spec"].accumulate in LOW
    return e.kind == "op" and e.name in PRODUCT_OPS and any(
        t.dtype in LOW for t in e.outputs)


@rule("precision/bf16-dot-accumulate")
def bf16_dot_accumulate(ctx: AnalysisContext) -> Iterable[Finding]:
    """Every product over bf16/f16 operands accumulates in f32 (a kernel
    declares its accumulator in its spec; an aten product with a bf16
    result rounds every partial sum)."""
    if ctx.trace is None:
        return
    for i, e in enumerate(ctx.trace.events):
        if _accumulates_low(e):
            out = e.outputs[0].dtype if e.outputs else "?"
            yield Finding(
                "precision/bf16-dot-accumulate", Severity.ERROR,
                f"event {i} ({e.name}): product over {_low(e)} operands "
                f"accumulates in {out} (no f32 upcast)",
                location=f"{i}:{e.name}",
                details={"operand_dtypes": [t.dtype for t in e.inputs],
                         "result_dtype": out})


@rule("precision/bf16-reduce", severity=Severity.WARNING)
def bf16_reduce(ctx: AnalysisContext) -> Iterable[Finding]:
    """Reductions over bf16 carry the accumulator in f32 (a warning, as in
    the reference)."""
    if ctx.trace is None:
        return
    for i, e in enumerate(ctx.trace.events):
        if e.kind == "op" and e.name in REDUCE_OPS and _low(e) and any(
                t.dtype in LOW for t in e.outputs):
            yield Finding(
                "precision/bf16-reduce", Severity.WARNING,
                f"event {i} ({e.name}) reduces in {e.outputs[0].dtype}",
                location=f"{i}:{e.name}",
                details={"result_dtype": e.outputs[0].dtype})


@rule("precision/no-f64")
def no_f64(ctx: AnalysisContext) -> Iterable[Finding]:
    """No f64/c128 value anywhere in the run (an accidental Python-float
    or numpy promotion doubles bytes on the wire and in memory)."""
    if ctx.trace is None or ctx.expectations.get("allow_f64"):
        return
    for t in ctx.trace.tensors().values():
        if t.dtype in WIDE:
            yield Finding(
                "precision/no-f64", Severity.ERROR,
                f"tensor #{t.id} {list(t.shape)} is {t.dtype}",
                location=f"tensor#{t.id}",
                details={"shape": list(t.shape), "dtype": t.dtype})


def check_trace_precision(tape, allow_f64: bool = False) -> list[Finding]:
    """Dataflow walk over the trace's tensor identities: a value stored in
    bf16/f16 reaches an aten product only through an upcast (a kernel
    event may take bf16 operands where its spec accumulates in f32), and
    no event produces f64.  Importable directly; the registry rule wraps
    it."""
    findings: list[Finding] = []
    for i, e in enumerate(tape.events):
        loc = f"{i}:{e.name}"
        if not allow_f64 and any(t.dtype in WIDE for t in e.outputs):
            findings.append(Finding(
                "precision/trace-dataflow", Severity.ERROR,
                f"{e.name} produces {e.outputs[0].dtype} (x64 leak)",
                location=loc, details={"dtype": e.outputs[0].dtype}))
        low = _low(e)
        if not low:
            continue
        if (e.kind == "op" and e.name in PRODUCT_OPS) or _accumulates_low(e):
            findings.append(Finding(
                "precision/trace-dataflow", Severity.ERROR,
                f"{e.name} takes {low} operands without an f32 upcast "
                f"(accumulates narrow)",
                location=loc,
                details={"operand_dtypes": [t.dtype for t in e.inputs]}))
        elif e.kind == "op" and e.name in REDUCE_OPS and any(
                t.dtype in LOW for t in e.outputs):
            findings.append(Finding(
                "precision/trace-dataflow", Severity.WARNING,
                f"{e.name} accumulates in bf16/f16", location=loc))
    return findings


@rule("precision/trace-dataflow")
def trace_dataflow(ctx: AnalysisContext) -> Iterable[Finding]:
    """Dataflow walk over the trace: bf16 into a product or a reduction
    without an f32 upcast, and f64 leaks."""
    if ctx.trace is None:
        return
    yield from check_trace_precision(
        ctx.trace, allow_f64=bool(ctx.expectations.get("allow_f64")))
