"""Structured findings: what an audit reports instead of printing or
asserting.

Port of `Finding` from paddle_tpu/analysis/findings.py, the record the
obs audit `obs.audit_recompiles` returns.
The static-analysis passes that also emit it (the jaxpr audit, the AST
lint, the suppression baseline) wait for ROADMAP's "Static analysis"
entry.

Severity model:
  error   — definitely wrong, would misbehave at runtime
  warning — a perf/correctness hazard a gate fails on
  note    — informational; never fails a gate
"""
from __future__ import annotations

SEVERITIES = ("note", "warning", "error")


class Finding:
    """One detector hit: where, what, how bad, plus detector-specific data
    for JSON consumers."""

    __slots__ = ("detector", "severity", "loc", "message", "data",
                 "suppressed")

    def __init__(self, detector: str, severity: str, loc: str, message: str,
                 data: dict | None = None):
        assert severity in SEVERITIES, severity
        self.detector = detector
        self.severity = severity
        self.loc = loc          # "file.py:123" | "obs/watchdog:site" | ...
        self.message = message
        self.data = data or {}
        self.suppressed = False

    def to_dict(self) -> dict:
        return {"detector": self.detector, "severity": self.severity,
                "loc": self.loc, "message": self.message, "data": self.data,
                "suppressed": self.suppressed}

    def __repr__(self):
        tag = " [suppressed]" if self.suppressed else ""
        return (f"[{self.severity}/{self.detector}]{tag} {self.loc}: "
                f"{self.message}")
