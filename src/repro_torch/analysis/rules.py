"""lanelint layer 1 — the R1–R4 footprint rules over the registry.

Counterpart of ``repro.analysis.rules``.  Every registered communication
cell (``(collective, strategy)`` pair) runs on an 8-rank gloo world for
each topology of a small grid, under the collective recorder
(:func:`~repro_torch.analysis.footprint.record_collectives`), and four
invariants are checked on what it issued:

  R1  level-disjointness — node-level and lane-level groups never share
      an edge: no group may straddle nodes without covering the whole
      world, and a decomposed (lane*) strategy may not fall back to
      whole-world collectives at all (scalar-sized ops exempt).
  R2  payload conservation — the per-level wire bytes equal the closed
      form of what the cell issues (``comm/costs.py:
      lowered_wire_volumes``), exactly up to float rounding: nothing
      sits between a call and the recorder.
  R3  guideline consistency — the volumes the matching cost function
      charges (``comm/costs.py:assumed_volumes``) agree with the issued
      volumes within the cell's documented bound.  A cost model that
      under- or over-counts its own cell would rank dispatch with
      fiction.
  R4  overlap shape — pipelined cells must have a node phase and a lane
      phase in flight together (``footprint.overlap``); the blocking
      negative control must NOT (if it did, the rule would be vacuous —
      so that is a finding against the RULE, reported as ``R4`` on the
      control cell).

R1 and R4 hold on every rank's footprint; R2 and R3 on the busiest
process's (each level's maximum over the ranks), the process the §3
volumes describe.  Where ranks disagree, a message names the first rank
that shows the finding.  The step sweep (``analysis/steps.py``) runs R1
over the composed train and serve steps.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from . import footprint as fp
from .diagnostics import Finding

__all__ = [
    "CellCase", "GRID", "iter_cell_cases", "run_cell", "check_cell",
    "sweep_cells", "run_cell_rules", "check_step_footprint",
    "run_step_rules", "R2_REL_TOL", "R2_ABS_TOL", "SMALL_GLOBAL_BYTES",
]

#: (n, N) topologies every cell is swept over — both factorizations of
#: the 8 ranks with n ≥ 2 AND N ≥ 2 so node and lane levels are both
#: non-degenerate
GRID = ((4, 2), (2, 4))

#: per-process payload: 1024 f32 elements = 4 KiB — divides every K·n·N
#: split on the grid, so no cell pads and R2 algebra is exact
LOCAL_ELEMS = 1024

#: bucket/block count for cells that take one (explicit, so R2's closed
#: forms see the same K/B the cell uses)
SWEEP_BLOCKS = 4

R2_REL_TOL = 1e-9          # float rounding of the closed forms
R2_ABS_TOL = 512.0         # scalar side-channels (quorum denominator)
SMALL_GLOBAL_BYTES = 1024  # R1 scalar exemption (loss mean, grad norm)

#: the communication collectives the cell sweep drives (the registry also
#: carries builders — block_stack, serve_step, serve_scenario,
#: train_step — which are not collectives)
COMM_COLLECTIVES = ("allreduce", "reduce_scatter", "allgather", "alltoall",
                    "moe_route", "scan", "bcast", "reduce", "gather",
                    "scatter", "grad_sync", "prefetch_allgather",
                    "kv_splice")

#: cells that must show the §5 overlap structure (R4 positive)
PIPELINED_CELLS = frozenset({
    ("allreduce", "lane_pipelined"), ("grad_sync", "lane_pipelined"),
    ("bcast", "lane_pipelined"), ("reduce", "lane_pipelined"),
    ("prefetch_allgather", "lane_pipelined"),
})

#: negative controls that must FAIL the overlap check (pins R4 itself)
R4_CONTROL_CELLS = frozenset({("prefetch_allgather", "blocking")})

#: kv_splice's leaf: (layers, slot-sharded batch, feature), one slot a
#: process
_KV_SHAPE = (2, 1, 128)
_KV_SMALL_ELEMS = 2 * 1 * 128


@dataclasses.dataclass(frozen=True)
class CellCase:
    """One (collective, strategy) cell at one grid topology."""
    collective: str
    strategy: str
    n: int
    N: int
    payload_bytes: int
    kw: tuple = ()           # sorted kwargs items (hashable)

    @property
    def kwargs(self) -> dict:
        return dict(self.kw)

    @property
    def target(self) -> str:
        return f"{self.collective}/{self.strategy}@n{self.n}xN{self.N}"


def _cell_kwargs(collective: str, strategy: str) -> dict:
    if collective == "grad_sync":
        return {"num_buckets": SWEEP_BLOCKS}
    if collective == "prefetch_allgather" or strategy == "lane_pipelined":
        return {"num_blocks": SWEEP_BLOCKS}
    return {}


def iter_cell_cases(grid: tuple = GRID) -> Iterable[CellCase]:
    """Every registered communication cell × every grid topology."""
    import repro_torch.comm.impls  # noqa: F401  — populate the registry
    from repro_torch.comm.registry import iter_impls, registered_collectives
    for n, N in grid:
        for coll in registered_collectives():
            if coll not in COMM_COLLECTIVES:
                continue
            for e in iter_impls(coll):
                kw = _cell_kwargs(coll, e.strategy)
                payload = LOCAL_ELEMS * 4
                if coll == "kv_splice":
                    payload = _KV_SMALL_ELEMS * 4
                yield CellCase(coll, e.strategy, n, N, payload,
                               tuple(sorted(kw.items())))


# ---------------------------------------------------------------------------
# running one cell under the recorder
# ---------------------------------------------------------------------------

def run_cell(topo, case: CellCase, impl=None) -> fp.CommFootprint:
    """This process's footprint of one cell, run on ``topo`` (every
    process of the world makes the same call).  ``impl``: the
    ``fn(comm, x, **kw)`` to run instead of the registered one (the
    lint's negative controls)."""
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.comm.registry import get_impl
    comm = LaneComm(topo, CommConfig(record_selections=False))
    fn = impl or get_impl(case.collective, case.strategy).fn
    g = topo.global_rank()
    if case.collective == "kv_splice":
        big = torch.zeros(_KV_SHAPE)
        small = torch.arange(_KV_SMALL_ELEMS, dtype=torch.float32
                             ).reshape(_KV_SHAPE) + g
        with fp.record_collectives() as rec:
            fn(comm, big, small=small, slot=min(3, topo.p() - 1),
               **case.kwargs)
    else:
        x = torch.arange(LOCAL_ELEMS, dtype=torch.float32) + g
        with fp.record_collectives() as rec:
            fn(comm, x, **case.kwargs)
    return rec.footprint(n=topo.n(), num_devices=topo.p())


def _cells_rank(n: int, N: int) -> dict:
    """Every cell of the (n, N) topology on this rank: {target:
    footprint}."""
    from repro_torch.launch.mesh import new_lane_topology
    topo = new_lane_topology(n, N)
    return {case.target: run_cell(topo, case)
            for case in iter_cell_cases(((n, N),))}


def sweep_cells(grid: tuple = GRID) -> dict:
    """{(n, N): [rank 0's {target: footprint}, rank 1's, ...]}: one
    spawned gloo world of n·N ranks per topology runs every cell."""
    from repro_torch.launch.mesh import spawn
    return {(n, N): spawn(_cells_rank, n * N, n, N) for n, N in grid}


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _is_decomposed(strategy: str) -> bool:
    return strategy != "native"


def check_r1(case_target: str, foot: fp.CommFootprint, *,
             decomposed: bool,
             small_global_bytes: float = SMALL_GLOBAL_BYTES) -> list:
    """Level-disjointness findings for one footprint."""
    out = []
    for op in foot.mixed():
        if op.result_bytes <= small_global_bytes:
            # scalar control traffic (loss mean / global-norm sum over
            # the batch ranks, quorum denominator): latency-only, the
            # bandwidth decomposition R1 protects is not at stake
            continue
        out.append(Finding(
            "R1", case_target,
            f"{op.kind} (issue {op.issued}, ranks {list(op.ranks)}) "
            f"straddles nodes without covering the world: "
            f"group_size={op.group_size}, {op.result_bytes:.0f}B — node "
            f"and lane communicators share an edge"))
    if decomposed:
        for op in foot.ops:
            if op.level == "global" \
                    and op.result_bytes > small_global_bytes:
                out.append(Finding(
                    "R1", case_target,
                    f"decomposed strategy issues a whole-world {op.kind} "
                    f"({op.result_bytes:.0f}B, issue {op.issued}) — the "
                    f"decomposition fell back to a global collective"))
    return out


def _busiest(feet) -> dict:
    """Per-level wire bytes of the busiest process: each level's maximum
    over the footprints (one footprint: its own)."""
    if isinstance(feet, fp.CommFootprint):
        feet = [feet]
    levels = [f.by_level() for f in feet]
    return {lv: max(d[lv] for d in levels) for lv in fp.CommFootprint.LEVELS}


def _vol_mismatch(got: float, want: float, *, rel: float,
                  abs_tol: float) -> bool:
    return abs(got - want) > max(rel * max(got, want), abs_tol)


def check_r2(case: CellCase, feet) -> list:
    """Payload conservation: issued per-level wire == closed form.
    ``feet``: one footprint or every rank's."""
    from repro_torch.comm.costs import lowered_wire_volumes
    want = lowered_wire_volumes(
        case.collective, case.strategy, n=case.n, N=case.N,
        payload_bytes=case.payload_bytes, **case.kwargs)
    if want is None:
        return []
    got = _busiest(feet)
    out = []
    for level in ("node", "lane", "global"):
        w = float(want.get(level, 0.0))
        g = float(got.get(level, 0.0))
        if _vol_mismatch(g, w, rel=R2_REL_TOL, abs_tol=R2_ABS_TOL):
            out.append(Finding(
                "R2", case.target,
                f"{level}-level wire bytes: issued {g:.0f}, closed-form "
                f"{w:.0f} (payload {case.payload_bytes}B, "
                f"kw {dict(case.kw)}) — the cell does not move what "
                f"the §3/§5 algebra says it moves"))
    return out


def check_r3(case: CellCase, feet) -> list:
    """Guideline consistency: cost-model volumes vs issued volumes."""
    from repro_torch.comm.costs import assumed_volumes
    assumed = assumed_volumes(
        case.collective, case.strategy, n=case.n, N=case.N,
        payload_bytes=case.payload_bytes, **case.kwargs)
    if assumed is None:
        return []                       # cell has no cost model — nothing
    vols, bound = assumed
    got = _busiest(feet)
    out = []
    for level, w in vols.items():
        g = sum(got.values()) if level == "total" \
            else float(got.get(level, 0.0))
        if w <= 0:
            continue
        if g <= 0:
            out.append(Finding(
                "R3", case.target,
                f"cost model charges {w:.0f}B at the {level} level but "
                f"the cell moves nothing there — the model prices a "
                f"phase that does not exist"))
            continue
        ratio = max(g / w, w / g)
        if ratio > bound:
            out.append(Finding(
                "R3", case.target,
                f"{level}-level: cost model assumes {w:.0f}B, the cell "
                f"moves {g:.0f}B (ratio {ratio:.2f} > bound {bound:.2f}) "
                f"— dispatch would rank this cell with fiction"))
    return out


def check_r4(case: CellCase, foot: fp.CommFootprint, *,
             expect_overlap: bool) -> list:
    """Overlap shape: §5 pipelined cells must have a node op and a lane op
    in flight together; blocking controls must not."""
    pairs = fp.overlap(foot)
    if expect_overlap and not pairs:
        return [Finding(
            "R4", case.target,
            "pipelined cell shows NO node×lane pair in flight together "
            "— the §5 overlap structure is gone; every lane hop "
            "serializes behind a node phase")]
    if not expect_overlap and pairs:
        return [Finding(
            "R4", case.target,
            f"blocking negative control shows {len(pairs)} concurrent "
            f"node×lane pair(s) — the R4 rule would be vacuous; the "
            f"control must stay strictly serial")]
    return []


def _merge(per_rank: list) -> list:
    """One finding per key, the first rank's, named in its message."""
    seen: dict = {}
    for r, findings in enumerate(per_rank):
        for f in findings:
            if f.key not in seen:
                seen[f.key] = dataclasses.replace(
                    f, message=f"rank {r}: {f.message}")
    return list(seen.values())


def check_cell(case: CellCase, feet) -> list:
    """All applicable rules for one cell; ``feet``: every rank's
    footprint (or one)."""
    if isinstance(feet, fp.CommFootprint):
        feet = [feet]
    key = (case.collective, case.strategy)
    per_rank = []
    for foot in feet:
        found = check_r1(case.target, foot,
                         decomposed=_is_decomposed(case.strategy))
        if key in PIPELINED_CELLS:
            found += check_r4(case, foot, expect_overlap=True)
        elif key in R4_CONTROL_CELLS:
            found += check_r4(case, foot, expect_overlap=False)
        per_rank.append(found)
    return _merge(per_rank) + check_r2(case, feet) + check_r3(case, feet)


def run_cell_rules(grid: tuple = GRID, *, verbose: bool = False) -> list:
    """Run and check every registered cell over the grid."""
    findings = []
    for (n, N), ranks in sweep_cells(grid).items():
        for case in iter_cell_cases(((n, N),)):
            feet = [r[case.target] for r in ranks]
            cf = check_cell(case, feet)
            findings += cf
            if verbose:
                lv = {k: round(v, 1) for k, v in _busiest(feet).items()
                      if v}
                print(f"  {case.target:42s} {lv} "
                      f"{'FAIL ' + str(len(cf)) if cf else 'ok'}",
                      flush=True)
    return findings


# ---------------------------------------------------------------------------
# steps: R1 over the composed train/serve steps
# ---------------------------------------------------------------------------

def check_step_footprint(name: str, feet) -> list:
    """R1 over a step's footprints, one a rank.  Steps compose many
    cells, so only disjointness is checked here (volumes are owned by
    the cell sweep); scalar whole-world ops (loss mean, global-norm sum,
    quorum denominator) ride the small-payload exemption."""
    if isinstance(feet, fp.CommFootprint):
        feet = [feet]
    return _merge([check_r1(name, f, decomposed=True) for f in feet])


def run_step_rules(*, verbose: bool = False) -> list:
    """Run the lane train steps and the lane_zero3 serve step on an
    8-rank gloo world and check R1 over each."""
    from .steps import sweep_steps
    findings = []
    for name, feet in sweep_steps().items():
        sf = check_step_footprint(name, feet)
        findings += sf
        if verbose:
            lv = {k: round(v, 1) for k, v in _busiest(feet).items() if v}
            print(f"  {name:42s} {lv} "
                  f"{'FAIL ' + str(len(sf)) if sf else 'ok'}", flush=True)
    return findings
