"""Findings, severities, reports, and per-config waivers.

The port's own copy of ``repro.analysis.findings``, unchanged: a report's
JSON has the reference's shape.  A *finding* is one violated invariant at
one location; a *report* is the outcome of running a rule set over one
analysis context (one recorded config).  Waivers mute a rule for configs
that legitimately trip it — e.g. the dense-adjacency rule on the dense
baseline trainer — while keeping the finding visible in the report's
``waived`` list.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Iterable, Mapping, Optional, Sequence


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:   # "error", not "Severity.ERROR", in reports
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant at one location."""
    rule: str                          # rule id, e.g. "kernel/index-bounds"
    severity: Severity
    message: str
    location: str = ""                 # event / kernel operand name
    details: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {"rule": self.rule, "severity": str(self.severity),
                "message": self.message, "location": self.location,
                "details": dict(self.details)}

    def __str__(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        return f"[{self.severity}] {self.rule}{loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Waiver:
    """Mute ``rule`` on configs whose expectations match ``when``.

    ``when`` maps expectation keys to required values; an empty mapping
    waives the rule unconditionally.  Waived findings stay in the report
    (``report.waived``) so the JSON artifact still shows what was muted.
    """
    rule: str
    reason: str
    when: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def matches(self, finding: Finding,
                expectations: Mapping[str, Any]) -> bool:
        if finding.rule != self.rule:
            return False
        return all(expectations.get(k) == v for k, v in self.when.items())


@dataclasses.dataclass
class Report:
    """Findings from one rule run over one config."""
    config: str = ""
    expectations: dict[str, Any] = dataclasses.field(default_factory=dict)
    findings: list[Finding] = dataclasses.field(default_factory=list)
    waived: list[Finding] = dataclasses.field(default_factory=list)
    rules_run: list[str] = dataclasses.field(default_factory=list)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def findings_for(self, rule: str) -> list[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def no_findings(self, rule: Optional[str] = None,
                    min_severity: Severity = Severity.WARNING) -> bool:
        """True iff no finding at/above ``min_severity`` (for ``rule``)."""
        for f in self.findings:
            if rule is not None and f.rule != rule:
                continue
            if f.severity >= min_severity:
                return False
        return True

    def assert_no_findings(self, rule: Optional[str] = None,
                           min_severity: Severity = Severity.WARNING) -> None:
        if not self.no_findings(rule, min_severity):
            raise AssertionError(self.summary(rule))

    def summary(self, rule: Optional[str] = None) -> str:
        picked = [f for f in self.findings
                  if rule is None or f.rule == rule]
        head = (f"{self.config or 'analysis'}: "
                f"{len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s), "
                f"{len(self.waived)} waived, "
                f"{len(self.rules_run)} rule(s) run")
        return "\n".join([head] + [f"  {f}" for f in picked])

    def to_dict(self) -> dict[str, Any]:
        exp = {k: _jsonable(v) for k, v in self.expectations.items()}
        return {"config": self.config,
                "expectations": exp,
                "rules_run": list(self.rules_run),
                "findings": [f.to_dict() for f in self.findings],
                "waived": [f.to_dict() for f in self.waived]}

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), default=str, **kwargs)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    if isinstance(v, Mapping):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def no_findings(report_or_findings: "Report | Iterable[Finding]",
                rule: Optional[str] = None,
                min_severity: Severity = Severity.WARNING) -> bool:
    """Functional form for tests: ``assert no_findings(report, rule=...)``."""
    if isinstance(report_or_findings, Report):
        return report_or_findings.no_findings(rule, min_severity)
    rep = Report(findings=list(report_or_findings))
    return rep.no_findings(rule, min_severity)


def apply_waivers(findings: Sequence[Finding],
                  expectations: Mapping[str, Any],
                  waivers: Sequence[Waiver]
                  ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (kept, waived) under ``waivers``."""
    kept: list[Finding] = []
    muted: list[Finding] = []
    for f in findings:
        if any(w.matches(f, expectations) for w in waivers):
            muted.append(f)
        else:
            kept.append(f)
    return kept, muted
