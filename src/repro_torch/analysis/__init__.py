"""repro_torch.analysis — lanelint: communication-invariant analysis of
the port.

Counterpart of ``repro.analysis``, two layers over one diagnostics and
baseline spine:

* ``footprint`` — the collective recorder: every ``torch.distributed``
  call a cell or step issues, classified node/lane/global/mixed with its
  wire bytes, and the node×lane overlap of the pipelined cells
  (``repro`` parses compiled HLO; the port has none).
* ``rules`` — R1 level-disjointness, R2 payload conservation, R3
  guideline consistency, R4 overlap shape, over every registered
  ``(collective, strategy)`` cell on 8-rank gloo worlds; ``steps`` — the
  composed train and serve steps R1 runs over.
* ``astlint`` — A0 parse, A1 raw-collective containment, A2 no
  user-facing bare asserts, A3 seeded-determinism hygiene, A4
  priced-or-opted-out registry cells.
* ``lint`` — the CLI (``python -m repro_torch.analysis.lint``): exit 0
  clean / 1 findings / 2 internal error.
"""
from .baseline import (apply_baseline, default_baseline_path,
                       load_baseline, save_baseline)
from .diagnostics import ERROR, WARNING, Finding, format_findings
from .footprint import (CollOp, CommFootprint, classify_group, overlap,
                        record_collectives)

__all__ = [
    "Finding", "ERROR", "WARNING", "format_findings",
    "load_baseline", "save_baseline", "apply_baseline",
    "default_baseline_path",
    "CollOp", "CommFootprint", "classify_group", "record_collectives",
    "overlap",
]
