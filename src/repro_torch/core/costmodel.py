"""Paper §3/§5 cost model: rounds + volumes per hierarchy level, k-lane time.

Counterpart of ``repro.core.costmodel``, with the same closed forms.  The
paper analyses each full-lane mock-up under best-case, single-ported,
fully-connected assumptions; §5 defines the k-lane model (per step: one
inter-node send+recv and, simultaneously, exchanges with the k-1 on-node
peers).  The port uses them to rank strategies (``comm.costs``) and to
pick the gradient-sync bucket count.

Units: `c` is an element count per the MPI convention; multiply by
`elem_bytes` for wire bytes.  n = processes (GPUs) per node (host),
N = nodes (hosts), p = n·N, k = physical lanes.

The hardware constants (``HW``) describe an H100 SXM host; see there for
which are spec-sheet values and which are assumptions.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["CollectiveCost", "mockup_cost", "klane_time", "speedup_bound",
           "HW", "get_hw", "set_hw", "optimal_num_buckets",
           "bucket_pipeline_time", "optimal_prefetch_blocks"]


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Best-case cost of one full-lane mock-up (paper §3 analysis)."""
    name: str
    rounds_node: int         # communication rounds on nodecomm level
    rounds_lane: int         # rounds on lanecomm level
    vol_node: float          # elements sent+received per process, node level
    vol_lane: float          # elements sent+received per process, lane level
    vol_internode_per_node: float  # total elements in/out of one node
    optimal_vol: float       # per-process volume of an optimal direct algo


def _lg(x: int) -> int:
    return max(1, math.ceil(math.log2(max(2, x))))


def mockup_cost(coll: str, n: int, N: int, c: float) -> CollectiveCost:
    """Paper §3 best-case numbers for each full-lane mock-up."""
    p = n * N
    if coll == "bcast":
        # Scatter(node): ceil(log n) rounds, (n-1)/n·c; Bcast(lane):
        # ceil(log N), c/n; Allgather(node): ceil(log n), (n-1)/n·c.
        return CollectiveCost(
            "bcast", 2 * _lg(n), _lg(N),
            2 * (n - 1) / n * c, c / n, c, c)
    if coll in ("gather", "scatter"):
        # (n-1)Nc on the root node + (N-1)c on the lanes = (p-1)c total.
        return CollectiveCost(
            coll, _lg(n), _lg(N),
            (n - 1) * N * c, (N - 1) * c, (p - n) * c, (p - 1) * c)
    if coll == "allgather":
        # AG(lane): (N-1)c; AG(node): (n-1)Nc; total (p-1)c = optimal.
        return CollectiveCost(
            "allgather", _lg(n), _lg(N),
            (n - 1) * N * c, (N - 1) * c, (N - 1) * n * c, (p - 1) * c)
    if coll in ("allreduce", "reduce"):
        # RS(node)+AG(node): 2·(n-1)/n·c; AR(lane): 2·(N-1)/N·c/n.
        return CollectiveCost(
            coll, 2 * _lg(n), 2 * _lg(N),
            2 * (n - 1) / n * c, 2 * (N - 1) / N * c / n,
            2 * (N - 1) / N * c, 2 * (p - 1) / p * c)
    if coll == "reduce_scatter":
        # RS(node): (n-1)/n·c; RS(lane): (N-1)/N·c/n.
        return CollectiveCost(
            "reduce_scatter", _lg(n), _lg(N),
            (n - 1) / n * c, (N - 1) / N * c / n,
            (N - 1) / N * c, (p - 1) / p * c)
    if coll == "alltoall":
        # A2A(lane): (N-1)n·c_blk rows with c = p·c_blk total per proc —
        # per paper §3.5 with per-destination block c: (N-1)nc + (n-1)Nc.
        return CollectiveCost(
            "alltoall", 1, 1,
            (n - 1) * N * c, (N - 1) * n * c, (N - 1) * n * c * n,
            (p - 1) * c)
    raise ValueError(f"unknown collective {coll!r}")


def klane_time(cost: CollectiveCost, *, k: int, elem_bytes: int,
               alpha_node: float, beta_node: float,
               alpha_lane: float, beta_lane: float) -> float:
    """Predicted seconds in the k-lane model (paper §5).

    The lane-level part is carried by k physical lanes concurrently (it is
    already expressed per-process = per-lane); the node-level part is the
    serial bottleneck the paper identifies.  alpha = per-round latency,
    beta = seconds/byte at that level.
    """
    t_node = cost.rounds_node * alpha_node + cost.vol_node * elem_bytes * beta_node
    t_lane = cost.rounds_lane * alpha_lane + cost.vol_lane * elem_bytes * beta_lane
    return t_node + t_lane


def speedup_bound(coll: str, n: int, N: int, k: int) -> float:
    """Upper bound on full-lane speedup vs single-root hierarchical algo:
    the inter-node phase accelerates by ≤ k; node phases don't."""
    return float(min(k, n))


# ---------------------------------------------------------------------------
# H100 host constants
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HW:
    """An 8-GPU H100 SXM host, the node level on NVLink and one NIC per GPU
    for the lane level.

    Spec-sheet values (NVIDIA H100 Tensor Core GPU datasheet; DGX H100
    user guide), not measurements:

      peak_flops_bf16  989e12 FLOP/s: H100 SXM, bf16 dense tensor cores.
      hbm_bw           3.35e12 B/s: H100 SXM, HBM3.
      node_bw          450e9 B/s: NVLink 4, 900 GB/s per GPU both
                       directions together, so 450 GB/s each way.
      lane_bw          50e9 B/s: one 400 Gb/s ConnectX-7 NIC per GPU.
      gpus_per_host    8.

    Assumptions, neither measured nor fitted (the tuner that fits them
    from timings is ROADMAP.md, Queue 1, item 10):

      alpha_node       10e-6 s: one NCCL collective within a host.
      alpha_lane       25e-6 s: one NCCL collective across hosts.

    Every cost reads the constants through ``get_hw()`` at call time, so
    a fitted instance installed by ``set_hw`` takes effect everywhere.
    """
    peak_flops_bf16: float = 989e12
    hbm_bw: float = 3.35e12
    node_bw: float = 450e9
    lane_bw: float = 50e9
    gpus_per_host: int = 8
    alpha_node: float = 10e-6
    alpha_lane: float = 25e-6


_ACTIVE_HW: HW = HW()


def get_hw() -> HW:
    """The active hardware constants (spec-sheet default or fitted)."""
    return _ACTIVE_HW


def set_hw(hw: "HW | None") -> HW:
    """Install ``hw`` as the active constants (None restores the
    default).  Returns the previous instance so callers can scope the
    change."""
    global _ACTIVE_HW
    prev = _ACTIVE_HW
    _ACTIVE_HW = HW() if hw is None else hw
    return prev


# ---------------------------------------------------------------------------
# §5 pipelining: bucket-count choice from the latency/bandwidth crossover
# ---------------------------------------------------------------------------

def bucket_pipeline_time(c_bytes: float, K: int, *, stages: int = 3,
                         alpha: "float | None" = None,
                         beta: "float | None" = None) -> float:
    """Predicted seconds for K buckets through an S-stage pipeline.

    Standard pipeline algebra: (K + S - 1) waves, each costing one stage's
    alpha plus the per-bucket bandwidth term c/K·beta.  The bandwidth term
    is taken at the slowest level (the lane hop by default; None resolves
    alpha/beta from the active constants) — the other stages overlap
    under it once the pipeline is full.
    """
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    hw = get_hw()
    alpha = hw.alpha_lane if alpha is None else alpha
    beta = 1.0 / hw.lane_bw if beta is None else beta
    return (K + stages - 1) * (alpha + c_bytes * beta / K)


def optimal_num_buckets(c_bytes: float, *, stages: int = 3,
                        alpha: "float | None" = None,
                        beta: "float | None" = None,
                        max_buckets: int = 64) -> int:
    """Bucket count K from the k-lane latency/bandwidth crossover.

    Minimizing bucket_pipeline_time over K:  d/dK (K+S-1)(alpha + cβ/K)
    = alpha - (S-1)·cβ/K² = 0  ⇒  K* = sqrt((S-1)·cβ/alpha).  Below the
    crossover payload (cβ ≲ alpha) a single bucket wins; far above it the
    win saturates at ~S× while per-bucket alphas accumulate, hence the
    clamp.  Deterministic in its inputs and the active HW, so every rank
    agrees on K.
    """
    if c_bytes <= 0:
        return 1
    hw = get_hw()
    alpha = hw.alpha_lane if alpha is None else alpha
    beta = 1.0 / hw.lane_bw if beta is None else beta
    k_star = math.sqrt(max(stages - 1, 1) * c_bytes * beta / alpha)
    return max(1, min(max_buckets, int(round(k_star))))


def optimal_prefetch_blocks(shard_bytes: float, *, max_blocks: int = 16) -> int:
    """Block count B for the ZeRO-3 per-layer weight all-gather pipeline
    (the 2-stage AG(lane)→AG(node) of
    :func:`repro_torch.core.pipeline.pipelined_allgather_lane`), where
    ``shard_bytes`` is the per-GPU 1/p stripe of one layer's flat weights.
    """
    from .pipeline import ALLGATHER_STAGES
    return optimal_num_buckets(shard_bytes, stages=ALLGATHER_STAGES,
                               max_buckets=max_blocks)
