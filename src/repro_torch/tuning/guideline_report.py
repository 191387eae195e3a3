"""Guideline report: measured decomposed-vs-native verdicts per cell.

Counterpart of ``repro.tuning.guideline_report``; the ``fit`` block
names the port's levels (``node`` / ``lane``).

The paper's self-consistent performance guidelines say when a
decomposed (lane) algorithm should beat the native one.  With a
measured TimingTable in hand we can stop asserting that from the model
and simply CHECK it: for every (collective, payload-bucket) cell that
has both a native measurement and at least one decomposed measurement,
compare the best decomposed median against the native median.

A cell is a **violation** when the best decomposed time exceeds
``tolerance ×`` native — i.e. decomposition did not just fail to win,
it actively cost more than the tolerance allows.  On a shared-memory
CPU backend the decomposed algorithms pay real pure overhead (there is
no second network level to exploit), so the smoke leg runs with a
loose tolerance; on real multi-NIC topologies the tolerance should be
≈1.  ``beats_native`` records the paper's headline direction per cell.

The emitted document (``tune_smoke``'s ``--out``) also carries the
fitted HW constants + residuals (:mod:`repro_torch.tuning.fit`) so the
report is a self-contained answer to "what did the machine measure, what constants
explain it, and do the guidelines hold there".
"""
from __future__ import annotations

from typing import Optional

from .fit import FitResult, fit_hw
from .table import TimingTable

__all__ = ["build_report", "DEFAULT_TOLERANCE"]

# CPU smoke default: decomposed emulation overhead on a shared-memory
# "topology" is real but bounded; 4× headroom keeps the CI leg about
# structure (nothing pathological) without pretending a host has lanes.
DEFAULT_TOLERANCE = 4.0


def _cells(table: TimingTable, tolerance: float) -> list:
    by_cell: dict = {}
    for e in table.entries():
        by_cell.setdefault((e.collective, e.topo_sig, e.bucket), []) \
            .append(e)
    cells = []
    for (coll, sig, bucket), entries in sorted(by_cell.items()):
        native = next((e for e in entries if e.strategy == "native"), None)
        decomposed = [e for e in entries if e.strategy != "native"]
        if native is None or not decomposed:
            continue        # nothing to compare in this cell
        best = min(decomposed, key=lambda e: e.median_us)
        ratio = best.median_us / max(native.median_us, 1e-9)
        cells.append({
            "collective": coll,
            "topo_sig": sig,
            "payload_bytes": native.payload_bytes,
            "native_us": round(native.median_us, 2),
            "best_decomposed_us": round(best.median_us, 2),
            "best_strategy": best.strategy,
            "ratio": round(ratio, 4),
            "beats_native": bool(best.median_us < native.median_us),
            "status": "ok" if ratio <= tolerance else "violation",
        })
    return cells


def build_report(table: TimingTable, *,
                 tolerance: float = DEFAULT_TOLERANCE,
                 fit: Optional[FitResult] = None) -> dict:
    """The guideline-report document for a measured table.

    ``fit`` defaults to fitting the table in place; pass an existing
    FitResult to avoid refitting (or after installing it via set_hw).
    ``ok`` is the CI verdict: no violations above tolerance.
    """
    if fit is None:
        fit = fit_hw(table)
    cells = _cells(table, tolerance)
    violations = [c for c in cells if c["status"] == "violation"]
    return {
        "topology": list(table.signatures()),
        "tolerance": tolerance,
        "measured_cells": len(table),
        "cells": cells,
        "violations": len(violations),
        "fit": {
            "alpha_node_s": fit.params["alpha_node"],
            "alpha_lane_s": fit.params["alpha_lane"],
            "node_bw_Bps": fit.hw.node_bw,
            "lane_bw_Bps": fit.hw.lane_bw,
            "residual_rms_us": round(fit.residual_rms_us, 2),
            "residual_max_us": round(fit.residual_max_us, 2),
            "num_cells": fit.num_cells,
        },
        "ok": not violations,
    }
