"""Memory rules: nothing dense-adjacency-shaped, nothing over budget, the
previous state freed by the step, no host reads but the line searches'.

The port's counterparts of ``repro.analysis.rules.memory``, read off the op
trace.  The loopback stacks every shard's lanes on one device, so where the
reference bounds one shard's program, these rules bound ``n_shards`` shards'
worth (the bound the reference checks, times the shards stacked); a rank
of the process transport holds one shard, and its bounds are one shard's
(``hosted_shards``).
"""
from __future__ import annotations

import math
from typing import Iterable

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import AnalysisContext, rule
from repro_torch.analysis.trace import PRODUCT_OPS, Trace

# the aggregation kernels: their output is an aggregated (k, n_pad, C) stack
AGG_KERNELS = frozenset({"community_spmm_ell", "community_spmm_ell_packed",
                         "community_spmm"})
# ops whose output is the same stack as an input (views, copies, casts) and
# the elementwise ops a consumer folds an aggregate through before its
# product (the overlap's sum over arrival groups, a row mask)
_SAME_STACK = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "slice", "select", "alias", "detach",
    "as_strided", "clone", "contiguous", "_to_copy", "to", "narrow",
    "add", "mul", "where"})


def _shards(ctx: AnalysisContext) -> int:
    """The shards whose lanes this trace's program holds: every shard on
    the loopback, one on a rank of the process transport."""
    exp = ctx.expectations
    return int(exp.get("hosted_shards", exp.get("n_shards", 1)))


@rule("memory/no-dense-adjacency")
def no_dense_adjacency(ctx: AnalysisContext) -> Iterable[Finding]:
    """No tensor shaped like a dense block-adjacency row stack: trailing
    dims (n_pad, n_pad) with more leading blocks than the ELL store's
    m_total x max_deg (an input) or n_shards x lanes x max_deg (computed:
    every shard's lanes stacked)."""
    exp = ctx.expectations
    n_pad = exp.get("n_pad")
    if ctx.trace is None or not n_pad or exp.get("dense_adjacency_allowed"):
        return
    m_total = int(exp.get("m_total", 1))
    max_deg = int(exp.get("max_deg", m_total))
    input_blocks = max(m_total * max_deg, 1)
    compute_blocks = max(_shards(ctx) * int(exp.get("lanes", 1)) * max_deg,
                         1)
    produced = ctx.trace.produced()
    for t in ctx.trace.tensors().values():
        if len(t.shape) < 3 or t.shape[-1] != n_pad or t.shape[-2] != n_pad:
            continue
        blocks = math.prod(t.shape[:-2])
        allowed = compute_blocks if t.id in produced else input_blocks
        if blocks > allowed:
            yield Finding(
                "memory/no-dense-adjacency", Severity.ERROR,
                f"tensor #{t.id} {list(t.shape)} holds {blocks} "
                f"({n_pad}x{n_pad}) blocks — dense-adjacency shaped; the ELL "
                f"bound is {allowed}",
                location=f"tensor#{t.id}",
                details={"shape": list(t.shape), "blocks": blocks,
                         "allowed_blocks": allowed})


@rule("memory/packed-resident-state")
def packed_resident_state(ctx: AnalysisContext) -> Iterable[Finding]:
    """Under packed state (multi-shard p2p, ``packed=True``) no computed
    blocked row stack (rows, n_pad, C ≠ n_pad) is taller than the shards'
    receive views, n_shards x r_pad rows: a taller one is a strided
    (M, n_pad, C) payload per shard sneaking back in."""
    exp = ctx.expectations
    n_pad = exp.get("n_pad")
    if ctx.trace is None or not n_pad or not exp.get("state_packed"):
        return
    bound = int(exp.get("packed_rows_bound", 0)) * _shards(ctx)
    if bound <= 0:
        return
    produced = ctx.trace.produced()
    for t in ctx.trace.tensors().values():
        s = t.shape
        if len(s) != 3 or s[-2] != n_pad or s[-1] == n_pad:
            continue
        if t.id in produced and s[0] > bound:
            yield Finding(
                "memory/packed-resident-state", Severity.ERROR,
                f"tensor #{t.id} is a ({s[0]}, {n_pad}, {s[-1]}) blocked "
                f"row stack — taller than the {bound} receive rows the "
                f"packed layout allows over {_shards(ctx)} shard(s)",
                location=f"tensor#{t.id}",
                details={"shape": list(s), "rows": s[0],
                         "packed_rows_bound": bound})


def fused_agg_handoffs(tape: Trace, n_pad: int) -> list[dict]:
    """Aggregated block stacks handed to a product, from a dataflow walk.

    A *stack* is the (rows, n_pad, C ≠ n_pad) output of an aggregation
    kernel event (ELL, packed or dense; on the CPU the plain version that
    stands in for it).  Views, copies, casts and the elementwise ops a
    consumer folds an aggregate through (add, mul, where) carry the stack;
    anything else ends it, so a product's output is never a stack.  A
    *handoff* is a stack some aten product (``mm``, ``bmm``, ...) or kernel
    consumes, each stack counted once however many products read it (the
    W-update's line search re-reads one per layer).  Importable directly
    (tests); the registry rule wraps it."""
    stack: dict[int, int] = {}
    info: dict[int, dict] = {}
    consumed: dict[int, dict] = {}
    for i, e in enumerate(tape.events):
        held = [stack[t.id] for t in e.inputs if t.id in stack]
        product = (e.kind == "kernel"
                   or (e.kind == "op" and e.name in PRODUCT_OPS))
        if product:
            for s in held:
                consumed.setdefault(s, dict(info[s], consumer=f"{i}:{e.name}"))
        if e.kind == "kernel" and e.name in AGG_KERNELS:
            for t in e.outputs:
                sh = t.shape
                if len(sh) == 3 and sh[-2] == n_pad and sh[-1] != n_pad:
                    stack[t.id] = i
                    info[i] = {"producer": f"{i}:{e.name}",
                               "shape": list(sh)}
        elif e.kind == "op" and held and e.name in _SAME_STACK \
                and not e.inplace:
            for t in e.outputs:
                stack[t.id] = held[0]
    return list(consumed.values())


@rule("memory/fused-no-intermediate")
def fused_no_intermediate(ctx: AnalysisContext) -> Iterable[Finding]:
    """Under ``TrainerConfig(fused=True)`` no more aggregated
    ``(rows, n_pad, C)`` stacks reach a product than the W-update allows
    (one per layer: its line search re-reads the aggregate under a varying
    W); every Z-update site runs the fused kernel, which keeps its
    aggregate in shared memory (on the CPU: the reassociated A·(Z·W))."""
    exp = ctx.expectations
    n_pad = exp.get("n_pad")
    if ctx.trace is None or not n_pad or not exp.get("fused"):
        return
    allowed = int(exp.get("fused_max_agg_handoffs", 0))
    found = fused_agg_handoffs(ctx.trace, int(n_pad))
    if len(found) > allowed:
        yield Finding(
            "memory/fused-no-intermediate", Severity.ERROR,
            f"{len(found)} aggregated (rows, {n_pad}, C) stacks reach a "
            f"product — the fused step allows {allowed} (the W-update "
            f"line-search aggregates); extra handoffs mean an unfused "
            f"aggregation→GEMM site materialises its aggregate",
            location=found[0].get("consumer"),
            details={"handoffs": found[:16], "allowed": allowed,
                     "count": len(found)})


@rule("memory/hbm-intermediate-budget")
def hbm_intermediate_budget(ctx: AnalysisContext) -> Iterable[Finding]:
    """No single computed tensor exceeds ``hbm_intermediate_budget``
    bytes."""
    budget = ctx.expectations.get("hbm_intermediate_budget")
    if ctx.trace is None or budget is None:
        return
    produced = ctx.trace.produced()
    for t in ctx.trace.tensors().values():
        if t.id in produced and t.nbytes > budget:
            yield Finding(
                "memory/hbm-intermediate-budget", Severity.ERROR,
                f"tensor #{t.id} {list(t.shape)} holds {t.nbytes} B "
                f"> budget {int(budget)} B",
                location=f"tensor#{t.id}",
                details={"bytes": t.nbytes, "budget": int(budget),
                         "shape": list(t.shape)})


@rule("memory/no-full-graph-tensors")
def no_full_graph_tensors(ctx: AnalysisContext) -> Iterable[Finding]:
    """Under ``full_graph_rows`` no tensor — inputs included — has a
    leading dim reaching the full-graph row count.  The serving hit path
    touches one community block and one request-row vector; a full-plane
    operand means its latency scales with the graph."""
    bound = ctx.expectations.get("full_graph_rows")
    if ctx.trace is None or not bound:
        return
    for t in ctx.trace.tensors().values():
        if t.shape and t.shape[0] >= int(bound):
            yield Finding(
                "memory/no-full-graph-tensors", Severity.ERROR,
                f"tensor #{t.id} is {list(t.shape)} — leading dim >= the "
                f"full-graph row bound {int(bound)}",
                location=f"tensor#{t.id}",
                details={"shape": list(t.shape), "bound": int(bound)})


@rule("memory/donated-inputs")
def donated_inputs(ctx: AnalysisContext) -> Iterable[Finding]:
    """Once ``step()`` returns nothing holds the previous state's Z/U (the
    eager counterpart of donating them to the step: kept, they double the
    state's memory)."""
    donated = ctx.expectations.get("args_donated")
    want = ctx.expectations.get("expect_donated")
    if not donated or not want:
        return
    for needle in want:
        matching = {p: d for p, d in donated.items()
                    if needle.lower() in p.lower()}
        if not matching:
            yield Finding(
                "memory/donated-inputs", Severity.WARNING,
                f"no state path matches '{needle}' — the donation "
                f"expectation is stale",
                details={"expected": needle, "args": sorted(donated)[:16]})
            continue
        kept = sorted(p for p, d in matching.items() if not d)
        if kept:
            yield Finding(
                "memory/donated-inputs", Severity.ERROR,
                f"{len(kept)} '{needle}' buffer(s) of the previous state "
                f"still alive after the step (first: {kept[0]})",
                location=kept[0],
                details={"expected": needle, "undonated": kept[:16]})


@rule("memory/host-transfer")
def host_transfer(ctx: AnalysisContext) -> Iterable[Finding]:
    """Every device → host read of the step (``_local_scalar_dense``, a
    copy to the host) is made on purpose: a line-search decision
    (``trace.decide``), or on the process transport a host staging copy
    or the step's count of bytes sent (``trace.marked``)."""
    if ctx.trace is None:
        return
    for i, e in enumerate(ctx.trace.events):
        if e.host_read and e.probe is None:
            yield Finding(
                "memory/host-transfer", Severity.ERROR,
                f"event {i} ({e.name}) reads the device on the host outside "
                f"a line-search decision",
                location=f"{i}:{e.name}",
                details={"shapes": [list(t.shape) for t in e.inputs]})
