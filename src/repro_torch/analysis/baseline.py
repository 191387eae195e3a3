"""Baseline suppression file for lanelint.

Counterpart of ``repro.analysis.baseline``, with a file of its own
(``lint_baseline_torch.json``), so the two lints never share a
suppression.

The baseline records findings that are UNDERSTOOD and accepted — each
entry must carry a ``reason`` (enforced on load), so the file doubles as
the justification log of the suppressions.  Matching is by ``Finding.key``
(``rule:target``, no line numbers), so suppressions survive unrelated
edits but never mask a new cell/file violating the same rule.

Format (JSON, sorted, diff-stable):

    {"version": 1,
     "entries": [{"rule": "A1", "target": "src/...#all_reduce",
                  "reason": "why this one is fine"}]}

``apply_baseline`` also returns the STALE entries (suppressions whose
finding no longer occurs): the lint CLI reports them as warnings so the
file cannot silently rot.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .diagnostics import Finding

__all__ = ["load_baseline", "save_baseline", "apply_baseline",
           "default_baseline_path", "BASELINE_VERSION"]

BASELINE_VERSION = 1
_DEFAULT_NAME = "lint_baseline_torch.json"


def default_baseline_path() -> str:
    """``lint_baseline_torch.json`` at the repo root (… /src/repro_torch/
    analysis/baseline.py → repo root is four parents up)."""
    here = os.path.abspath(os.path.dirname(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, _DEFAULT_NAME)


def load_baseline(path: Optional[str] = None) -> dict:
    """{key: entry-dict} from a baseline file; {} when the file does not
    exist (an empty baseline is the healthy steady state).  Malformed
    files and entries without a reason raise — a baseline that cannot be
    audited must not silently suppress anything."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported format "
                         f"{doc.get('version') if isinstance(doc, dict) else doc!r}")
    out: dict = {}
    for i, e in enumerate(doc.get("entries", [])):
        try:
            rule, target = str(e["rule"]), str(e["target"])
            reason = str(e["reason"])
        except (KeyError, TypeError) as exc:
            raise ValueError(f"baseline {path}: entry {i} malformed: {exc}")
        if not reason.strip():
            raise ValueError(f"baseline {path}: entry {i} "
                             f"({rule}:{target}) has no reason — every "
                             f"suppression must be justified")
        out[f"{rule}:{target}"] = {"rule": rule, "target": target,
                                   "reason": reason}
    return out


def save_baseline(findings: Iterable[Finding],
                  path: Optional[str] = None, *,
                  reason: str = "TODO: justify this suppression") -> str:
    """Write a baseline suppressing ``findings`` (sorted, deterministic).
    Existing reasons at the same key are preserved; new entries get the
    placeholder ``reason`` for the author to edit."""
    path = path or default_baseline_path()
    keep = {}
    if os.path.exists(path):
        keep = load_baseline(path)
    entries = []
    for f in sorted(findings, key=lambda f: f.key):
        prev = keep.get(f.key)
        entries.append({"rule": f.rule, "target": f.target,
                        "reason": prev["reason"] if prev else reason})
    doc = {"version": BASELINE_VERSION, "entries": entries}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def apply_baseline(findings: Iterable[Finding], baseline: dict) -> tuple:
    """(unsuppressed findings, stale baseline keys).

    A finding whose key appears in the baseline is suppressed; baseline
    entries matching NO current finding are stale and should be deleted
    (reported, so the file cannot accumulate dead weight)."""
    findings = list(findings)
    hit = {f.key for f in findings} & set(baseline)
    unsup = [f for f in findings if f.key not in baseline]
    stale = sorted(set(baseline) - hit)
    return unsup, stale
