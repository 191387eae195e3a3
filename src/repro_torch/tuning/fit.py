"""Least-squares fit of the §3/§5 constants from measured timings.

Counterpart of ``repro.tuning.fit``, with the port's level names: the
node level (``repro``'s ICI) and the lane level (``repro``'s DCN).  The
closed forms keep doing the RANKING (that is the paper's point — the
structure of the cost model is the analysis), but the constants
(``HW.alpha_node``/``alpha_lane`` latencies, ``node_bw``/``lane_bw``
bandwidths) are fitted from the probe's TimingTable instead of a spec
sheet and assumptions.  Every §3/§5 cost in
:mod:`repro_torch.comm.costs` is LINEAR in the four parameters

    x = [alpha_node, beta_node, alpha_lane, beta_lane]      (beta = s/B)

(``repro``'s ``[alpha_ici, beta_ici, alpha_dcn, beta_dcn]``, in the same
order) once the bucket count K is pinned, so each measured cell
contributes one row of an ordinary least-squares system ``A @ x = t``:

  native          rounds·alpha + optimal_vol·beta at the slowest level
  lane            [rounds_node, vol_node, rounds_lane, vol_lane]
                  (klane_time)
  lane_pipelined  (K+S-1)·alpha + (K+S-1)·(stripe/K)·beta at the
                  slowest level, with K resolved the way dispatch
                  resolves it (under the active HW at fit time — the
                  one nonlinearity, pinned rather than fitted)

``fit_hw`` solves the system, clamps the solution to physical ranges
(a fit can go degenerate — at p = 1 no row sees the lane bandwidth),
and reports residuals per cell so the guideline report records how well
the paper's forms explain the measured regime.  The fitted constants
are returned as a fresh :class:`~repro_torch.core.costmodel.HW`;
installing them is the caller's explicit step
(``core.costmodel.set_hw``) — never a side effect of fitting, because
the bucket/block resolutions feed ZeRO shard layouts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costmodel import HW, _lg, get_hw, mockup_cost, \
    optimal_num_buckets
from repro_torch.core.pipeline import ALLGATHER_STAGES, ALLREDUCE_STAGES

from .table import TimingTable, parse_topology_signature

__all__ = ["FitResult", "design_row", "fit_hw", "predicted_us"]

_PARAM_NAMES = ("alpha_node", "beta_node", "alpha_lane", "beta_lane")

# the fit's clamp: lstsq happily returns negative latencies on a
# degenerate fit, and a cost model must stay monotone in payload
ALPHA_FLOOR = 1e-9                      # s
BETA_FLOOR = 1e-13                      # s/B

# grad_sync is charged as the allreduce it is (same mapping as the
# registry's cost= assignments in repro_torch.comm.impls)
_MOCKUP_COLL = {"grad_sync": "allreduce"}

_ROUND_FACTOR = {"allreduce": 2, "reduce": 2, "bcast": 2, "grad_sync": 2}

_PIPELINE_STAGES = {"grad_sync": ALLREDUCE_STAGES,
                    "allreduce": ALLREDUCE_STAGES,
                    "prefetch_allgather": ALLGATHER_STAGES}


def design_row(collective: str, strategy: str, n: int, N: int,
               c_bytes: float) -> np.ndarray:
    """One least-squares row: coefficients of [alpha_node, beta_node,
    alpha_lane, beta_lane] such that row @ x = predicted seconds —
    mirroring the corresponding cost function in repro_torch.comm.costs."""
    row = np.zeros(4)
    coll = _MOCKUP_COLL.get(collective, collective)
    p = max(n * N, 1)
    lvl = 2 if N > 1 else 0             # slowest-level param offset
    if strategy == "native":
        rounds = _ROUND_FACTOR.get(collective, 1) * _lg(p)
        row[lvl] = rounds
        row[lvl + 1] = mockup_cost(coll, n, N, c_bytes).optimal_vol
        return row
    if strategy == "lane":
        cost = mockup_cost(coll, n, N, c_bytes)
        row[0] = cost.rounds_node
        row[1] = cost.vol_node
        row[2] = cost.rounds_lane
        row[3] = cost.vol_lane
        return row
    if strategy == "lane_pipelined":
        stages = _PIPELINE_STAGES[collective]
        stripe = c_bytes / max(n, 1) \
            if collective in ("grad_sync", "allreduce") else c_bytes
        hw = get_hw()                   # K pinned under the active HW
        alpha = hw.alpha_lane if N > 1 else hw.alpha_node
        beta = 1.0 / (hw.lane_bw if N > 1 else hw.node_bw)
        K = max(optimal_num_buckets(stripe, stages=stages, alpha=alpha,
                                    beta=beta), 1)
        waves = K + stages - 1
        row[lvl] = waves
        row[lvl + 1] = waves * stripe / K
        return row
    raise ValueError(
        f"no design row for ({collective!r}, {strategy!r}) — the fitter "
        f"covers the auto-eligible §3/§5 forms")


def predicted_us(collective: str, strategy: str, n: int, N: int,
                 c_bytes: float, hw: HW) -> float:
    """The design row priced under ``hw``, in µs."""
    x = np.array([hw.alpha_node, 1.0 / hw.node_bw,
                  hw.alpha_lane, 1.0 / hw.lane_bw])
    return float(design_row(collective, strategy, n, N, c_bytes) @ x) * 1e6


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Fitted constants + how well they explain the measurements."""
    hw: HW
    params: dict            # name -> fitted value (post-clamp)
    residual_rms_us: float
    residual_max_us: float
    num_cells: int
    cells: tuple            # per-cell {..., measured_us, fitted_us}
    blind: tuple = ()       # levels no cell moves bytes over


def fit_hw(table: TimingTable, *, topo_sig: str = None) -> FitResult:
    """Least-squares fit over every table cell with a known design row.

    ``topo_sig`` restricts the fit to one topology signature (default:
    all — each entry's (n, N) comes out of its own signature).  The
    solution is clamped to ``ALPHA_FLOOR``/``BETA_FLOOR``, and the
    residuals are computed against the CLAMPED parameters — the numbers
    the report publishes are the numbers dispatch would actually be
    priced with.  ``blind`` names the levels over which no fitted cell
    moves a byte (at p = 1 and N = 1 the lane level, at n = 1 the node
    level): their bandwidths are the floors, not a measurement.
    """
    rows, times, meta = [], [], []
    for e in table.entries():
        if topo_sig is not None and e.topo_sig != topo_sig:
            continue
        try:
            n, N = parse_topology_signature(e.topo_sig)
            row = design_row(e.collective, e.strategy, n, N,
                             e.payload_bytes)
        except ValueError:
            continue            # cell outside the fitted §3/§5 forms
        rows.append(row)
        times.append(e.median_us * 1e-6)
        meta.append(e)
    if not rows:
        raise ValueError(
            "fit_hw: no fittable cells in the timing table"
            + (f" for signature {topo_sig!r}" if topo_sig else ""))
    A = np.asarray(rows)
    t = np.asarray(times)
    x, *_ = np.linalg.lstsq(A, t, rcond=None)
    x = np.maximum(x, [ALPHA_FLOOR, BETA_FLOOR, ALPHA_FLOOR, BETA_FLOOR])
    params = dict(zip(_PARAM_NAMES, (float(v) for v in x)))
    hw = dataclasses.replace(
        HW(),
        alpha_node=params["alpha_node"], node_bw=1.0 / params["beta_node"],
        alpha_lane=params["alpha_lane"], lane_bw=1.0 / params["beta_lane"])
    fitted = A @ x
    resid_us = (fitted - t) * 1e6
    cells = tuple(
        {"collective": e.collective, "strategy": e.strategy,
         "topo_sig": e.topo_sig, "payload_bytes": e.payload_bytes,
         "measured_us": round(e.median_us, 2),
         "fitted_us": round(float(f) * 1e6, 2)}
        for e, f in zip(meta, fitted))
    return FitResult(
        hw=hw, params=params,
        residual_rms_us=float(np.sqrt(np.mean(resid_us ** 2))),
        residual_max_us=float(np.max(np.abs(resid_us))),
        num_cells=len(meta), cells=cells,
        blind=tuple(name for name, c in (("node", 1), ("lane", 3))
                    if not A[:, c].any()))
