"""Rule registry and the analysis context rules run against.

The port's counterpart of ``repro.analysis.registry``.  A rule is a
function ``(AnalysisContext) -> Iterable[Finding]`` registered under a
stable id (``family/name``).  Rules *skip* (yield nothing) when the context
lacks what they inspect — a trace rule on a context without a trace is
vacuous, not an error — so one registry serves every entry point (trainer
analysis, hand-built traces in the tests, kernel-spec lints).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

from repro_torch.analysis.findings import (Finding, Report, Severity, Waiver,
                                           apply_waivers)
from repro_torch.analysis.trace import Census, Trace, trace_census

RuleFn = Callable[["AnalysisContext"], Iterable[Finding]]


@dataclasses.dataclass
class AnalysisContext:
    """What a rule may inspect.  Any field may be None/empty; rules skip
    what is absent.

    expectations — facts about the config under analysis that rules
    check the trace against.  Keys used by the built-in rules:

      transport                "p2p" | "allgather"
      n_shards                 shards of the trainer
      hosted_shards            shards this program holds (n_shards on the
                               loopback, 1 on a rank; default n_shards)
      round_pairs              list of per-round tuples of (src, dst)
      num_gathers              transport calls per trainer step
      collective_budget_bytes  bound on the transport's wire bytes
      allreduce_max_bytes      bound on any one shard's psum operand
      expect_zero_collectives  True on the serving paths
      m_total, lanes, n_pad, max_deg   layout facts for the dense-adjacency
                               pattern matcher
      dense_adjacency_allowed  True on the dense baseline config
      state_packed, packed_rows_bound  the packed resident state's bound
      fused, fused_max_agg_handoffs    the fused step's product allowance
      hbm_intermediate_budget  bound on any single intermediate's bytes
      full_graph_rows          bound on any tensor's leading dim (serving)
      args_donated             {state path: freed after the step}
      expect_donated           substrings of state paths that must be freed
      allow_f64                True to mute the f64-leak rules
      kernels                  list of {"spec", "scalars"} kernel entries
      smem_limit               shared memory a block may take (bytes)
    """
    trace: Optional[Trace] = None
    expectations: dict[str, Any] = dataclasses.field(default_factory=dict)
    config: str = ""

    def census(self) -> Census:
        return trace_census(self.trace or Trace())


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    fn: RuleFn
    severity: Severity                 # default severity, shown in catalogue
    doc: str

    @property
    def family(self) -> str:
        return self.id.split("/", 1)[0]


_REGISTRY: dict[str, Rule] = {}


def rule(id: str, *, severity: Severity = Severity.ERROR
         ) -> Callable[[RuleFn], RuleFn]:
    """Register a rule under ``id`` (``family/name``)."""
    def deco(fn: RuleFn) -> RuleFn:
        doc = (fn.__doc__ or "").strip().splitlines()
        _REGISTRY[id] = Rule(id, fn, severity, doc[0] if doc else "")
        return fn
    return deco


def get_rule(id: str) -> Rule:
    _ensure_builtin_rules()
    return _REGISTRY[id]


def all_rules(family: Optional[str] = None) -> list[Rule]:
    _ensure_builtin_rules()
    rules = sorted(_REGISTRY.values(), key=lambda r: r.id)
    if family is not None:
        rules = [r for r in rules if r.family == family]
    return rules


def _ensure_builtin_rules() -> None:
    # rule modules self-register on import; idempotent
    from repro_torch.analysis.rules import (collective, kernel,  # noqa: F401
                                            memory, precision)


def run_rules(ctx: AnalysisContext,
              rules: Optional[Sequence[str]] = None,
              waivers: Sequence[Waiver] = (),
              families: Optional[Sequence[str]] = None) -> Report:
    """Run (a subset of) the registry against ``ctx`` and build a Report."""
    _ensure_builtin_rules()
    if rules is not None:
        picked = [get_rule(r) for r in rules]
    else:
        picked = all_rules()
        if families is not None:
            fams = set(families)
            picked = [r for r in picked if r.family in fams]
    found: list[Finding] = []
    for r in picked:
        found.extend(r.fn(ctx))
    kept, muted = apply_waivers(found, ctx.expectations, waivers)
    return Report(config=ctx.config,
                  expectations=dict(ctx.expectations),
                  findings=kept, waived=muted,
                  rules_run=[r.id for r in picked])


def analyze_trace(tape: Optional[Trace],
                  expectations: Optional[Mapping[str, Any]] = None,
                  *, config: str = "",
                  rules: Optional[Sequence[str]] = None,
                  waivers: Sequence[Waiver] = ()) -> Report:
    """Lint a recorded op trace against ``expectations``."""
    ctx = AnalysisContext(trace=tape, expectations=dict(expectations or {}),
                          config=config)
    return run_rules(ctx, rules=rules, waivers=waivers)
