"""Structured lint diagnostics: one Finding per violated rule instance.

Counterpart of ``repro.analysis.diagnostics``, the same class and keys.

A finding's identity (``key``) is ``rule:target`` — deliberately free of
line numbers and volatile details, so a baseline entry written once keeps
suppressing the same architectural fact across unrelated edits, while a
NEW violation of the same rule in a different cell/file is never masked.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding", "ERROR", "WARNING", "format_findings"]

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    rule:     catalog id ("R1".."R4" footprint rules, "A0".."A4" AST
              rules).
    severity: "error" fails the lint run; "warning" is reported only.
    target:   stable identity of WHERE — a registry cell
              ("allreduce/lane@n4xN2"), a file-scoped symbol
              ("src/repro_torch/foo.py#all_reduce"), or a step builder.  Never
              contains line numbers (those go in the message) so baseline
              suppressions survive unrelated edits.
    message:  human-readable what/why, with the measured numbers.
    """
    rule: str
    target: str
    message: str
    severity: str = ERROR

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.target}"

    def render(self) -> str:
        return f"{self.severity.upper()} {self.rule} {self.target}: " \
               f"{self.message}"


def format_findings(findings) -> str:
    """Deterministic multi-line report (sorted by key, errors first)."""
    order = sorted(findings,
                   key=lambda f: (f.severity != ERROR, f.key))
    return "\n".join(f.render() for f in order)
