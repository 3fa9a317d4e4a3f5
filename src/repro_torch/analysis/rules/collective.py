"""Collective rules: the transport contract, read off the op trace.

The port's counterparts of ``repro.analysis.rules.collective``.  Both
transports record one event per exchange (its rounds' source →
destination pairs, rows and wire bytes: on a rank of the process
transport the rounds it takes part in and what it sends) and per
all-gather, and the W update one event per shard-ordered sum (the
reference's psum).  The rules
hold those events to the host-side ``NeighborExchange`` plan.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import AnalysisContext, rule
from repro_torch.analysis.trace import TRANSPORTS


def _events(ctx: AnalysisContext, *kinds: str):
    return ctx.trace.of_kind(*kinds) if ctx.trace is not None else []


@rule("collective/no-allgather-under-p2p")
def no_allgather_under_p2p(ctx: AnalysisContext) -> Iterable[Finding]:
    """Under ``transport="p2p"`` the step runs no all-gather: the
    loopback's all-gather is its only route to a gathered (M, n_pad, C)
    payload on every shard."""
    if ctx.trace is None or ctx.expectations.get("transport") != "p2p":
        return
    hits = _events(ctx, "allgather")
    if hits:
        shape = list(hits[0].outputs[0].shape) if hits[0].outputs else []
        yield Finding(
            "collective/no-allgather-under-p2p", Severity.ERROR,
            f"{len(hits)} all-gather(s) recorded under p2p transport "
            f"(first gathers a {shape} payload to every shard)",
            location="allgather",
            details={"count": len(hits), "shape": shape})


@rule("collective/zero-collectives")
def zero_collectives(ctx: AnalysisContext) -> Iterable[Finding]:
    """Under ``expect_zero_collectives`` the run records no transport and
    no shard sum — the serving hit and halo paths are single-device
    programs over one resident plane."""
    if ctx.trace is None or \
            not ctx.expectations.get("expect_zero_collectives"):
        return
    hits = _events(ctx, *TRANSPORTS, "shard_sum")
    if hits:
        yield Finding(
            "collective/zero-collectives", Severity.ERROR,
            f"{len(hits)} collective event(s) in a run expected to be "
            f"collective-free (first: {hits[0].kind})",
            location=hits[0].kind,
            details={"count": len(hits),
                     "kinds": [e.kind for e in hits[:8]]})


@rule("collective/allreduce-payload")
def allreduce_payload(ctx: AnalysisContext) -> Iterable[Finding]:
    """Every shard's operand of a shard sum stays within
    ``allreduce_max_bytes`` (the W-update psum moves objective values and
    weight-sized gradients — a feature-matrix-sized operand is a transport
    leak)."""
    budget = ctx.expectations.get("allreduce_max_bytes")
    if ctx.trace is None or budget is None:
        return
    for i, e in enumerate(_events(ctx, "shard_sum")):
        nbytes = max((t.nbytes for t in e.inputs), default=0)
        if nbytes > budget:
            yield Finding(
                "collective/allreduce-payload", Severity.ERROR,
                f"shard sum #{i} moves {nbytes} B per shard "
                f"> budget {budget} B",
                location=f"shard_sum[{i}]",
                details={"bytes": nbytes, "budget": int(budget)})


def _recorded_pair_sets(ctx: AnalysisContext) -> list[frozenset]:
    return [frozenset(tuple(p) for p in pairs)
            for e in _events(ctx, "exchange", "exchange_packed")
            for pairs, _, _ in e.info["rounds"] if pairs]


@rule("collective/permute-schedule")
def permute_schedule(ctx: AnalysisContext) -> Iterable[Finding]:
    """The distinct round pair sets the exchanges ran equal the host-side
    plan's per-round pair sets (the restricted sub-plan under
    minibatching), both ways."""
    rounds = ctx.expectations.get("round_pairs")
    if ctx.trace is None or not rounds:
        return
    want = {frozenset(tuple(p) for p in r) for r in rounds}
    got = set(_recorded_pair_sets(ctx))
    if not got:
        yield Finding(
            "collective/permute-schedule", Severity.ERROR,
            f"no exchange round recorded but the host plan has "
            f"{len(want)} round(s)",
            details={"planned_rounds": sorted(sorted(r) for r in want)})
        return
    extra, missing = got - want, want - got
    if extra:
        yield Finding(
            "collective/permute-schedule", Severity.ERROR,
            f"{len(extra)} recorded round pair-set(s) not in the host "
            f"plan: {sorted(sorted(s) for s in extra)[:3]}",
            details={"unplanned": sorted(sorted(s) for s in extra)})
    if missing:
        yield Finding(
            "collective/permute-schedule", Severity.ERROR,
            f"{len(missing)} planned round(s) never ran: "
            f"{sorted(sorted(s) for s in missing)[:3]}",
            details={"missing": sorted(sorted(s) for s in missing)})


@rule("collective/permute-count", severity=Severity.WARNING)
def permute_count(ctx: AnalysisContext) -> Iterable[Finding]:
    """Rounds run = rounds × gathers of the plan (a warning, as in the
    reference)."""
    rounds = ctx.expectations.get("round_pairs")
    gathers = ctx.expectations.get("num_gathers")
    if ctx.trace is None or not rounds or not gathers:
        return
    n = len(_recorded_pair_sets(ctx))
    want = len(rounds) * gathers
    if n != want:
        yield Finding(
            "collective/permute-count", Severity.WARNING,
            f"{n} exchange round(s) recorded, expected {len(rounds)} "
            f"round(s) x {gathers} gather(s) = {want}",
            details={"recorded": n, "expected": want})


@rule("collective/payload-budget")
def payload_budget(ctx: AnalysisContext) -> Iterable[Finding]:
    """Recorded wire bytes (the exchanges' rounds, and every shard's copy
    of an all-gather) stay within the scheduled bound: the plan's
    ``wire_bytes`` under p2p, ``full_bytes`` under the all-gather."""
    budget = ctx.expectations.get("collective_budget_bytes")
    if ctx.trace is None or budget is None:
        return
    census = ctx.census()
    # the loopback records one shard's copy of an all-gather for every
    # shard it hosts; a rank records its own
    shards = int(ctx.expectations.get("hosted_shards",
                                      ctx.expectations.get("n_shards", 1)))
    per = {k: census.collectives[k]["bytes"] for k in TRANSPORTS}
    moved = per["exchange"] + per["exchange_packed"] + shards * per[
        "allgather"]
    if moved > budget:
        yield Finding(
            "collective/payload-budget", Severity.ERROR,
            f"recorded transport payload {moved:.0f} B exceeds the "
            f"scheduled bound {budget} B",
            details={"bytes": moved, "budget": int(budget), "per_kind": per})
