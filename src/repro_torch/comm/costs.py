"""Cost functions for auto-dispatch — the §3/§5 model per registration.

Counterpart of ``repro.comm.costs``, the closed forms only (``repro``'s
``lowered_wire_volumes`` / ``assumed_volumes`` check costs against
compiled HLO, which the port has no counterpart of; ROADMAP.md, Queue 1,
item 10).  Every function has the registry's cost signature ``(n, N,
payload_bytes, cfg) -> seconds`` with n = processes per node (GPUs per
host), N = nodes (hosts).  The constants are the active ones
(``core.costmodel.get_hw``).

* **native** — charged the collective's optimal per-process volume at the
  slowest level present (lane when N > 1, else node) with no lane
  concurrency: the paper's premise is that native libraries do not
  exploit multi-lane communication.  Rounds: log₂ p at that level's
  alpha.
* **lane** — ``klane_time`` over ``mockup_cost``: node phases at the node
  alpha/beta, lane phases at the lane alpha/beta with the full-lane 1/n
  payload split already folded into the §3 volumes.
* **lane_pipelined** — ``bucket_pipeline_time`` on the per-lane stripe
  with the bucket count the dispatcher would run (cfg.buckets, 0 = the K*
  crossover).
"""
from __future__ import annotations

from repro_torch.core.costmodel import (
    _lg, bucket_pipeline_time, get_hw, klane_time, mockup_cost,
    optimal_num_buckets,
)
from repro_torch.core.pipeline import ALLGATHER_STAGES, ALLREDUCE_STAGES

__all__ = [
    "native_cost", "lane_cost", "cost_pipelined_allreduce",
    "cost_pipelined_allgather", "cost_native_scan", "cost_lane_scan",
    "cost_lane_scatter",
]

_ROUND_FACTOR = {  # rounds multiplier: reduce+broadcast shapes pay 2 phases
    "allreduce": 2, "reduce": 2, "bcast": 2,
}


def _level(N: int, cfg) -> tuple[float, float]:
    """(alpha, beta) of the slowest level present: the lane iff N > 1."""
    hw = get_hw()
    if N > 1:
        return hw.alpha_lane, 1.0 / hw.lane_bw
    return hw.alpha_node, 1.0 / hw.node_bw


def native_cost(coll: str):
    """Single-lane native baseline for one §3 collective."""
    def cost(n: int, N: int, c_bytes: float, cfg) -> float:
        p = max(n * N, 1)
        alpha, beta = _level(N, cfg)
        rounds = _ROUND_FACTOR.get(coll, 1) * _lg(p)
        return rounds * alpha + mockup_cost(coll, n, N, c_bytes).optimal_vol \
            * beta
    return cost


def lane_cost(coll: str):
    """Full-lane mock-up under the k-lane model (paper §5)."""
    def cost(n: int, N: int, c_bytes: float, cfg) -> float:
        hw = get_hw()
        return klane_time(
            mockup_cost(coll, n, N, c_bytes), k=n, elem_bytes=1,
            alpha_node=hw.alpha_node, beta_node=1.0 / hw.node_bw,
            alpha_lane=hw.alpha_lane, beta_lane=1.0 / hw.lane_bw)
    return cost


def cost_pipelined_allreduce(n: int, N: int, c_bytes: float, cfg) -> float:
    """§5 pipelined allreduce: K buckets × 3 stages on the bottleneck
    stripe (the lane when multi-node, else the node level)."""
    alpha, beta = _level(N, cfg)
    stripe = c_bytes / max(n, 1)
    K = cfg.buckets if cfg.buckets > 0 \
        else optimal_num_buckets(stripe, alpha=alpha, beta=beta)
    return bucket_pipeline_time(stripe, max(K, 1), stages=ALLREDUCE_STAGES,
                                alpha=alpha, beta=beta)


def cost_pipelined_allgather(n: int, N: int, c_bytes: float, cfg) -> float:
    """§5 pipelined allgather (ZeRO-3 prefetch): B blocks × 2 stages.
    ``c_bytes`` is the per-process 1/p shard."""
    alpha, beta = _level(N, cfg)
    B = cfg.prefetch_blocks if cfg.prefetch_blocks > 0 \
        else optimal_num_buckets(c_bytes, stages=ALLGATHER_STAGES,
                                 alpha=alpha, beta=beta, max_buckets=16)
    return bucket_pipeline_time(c_bytes, max(B, 1), stages=ALLGATHER_STAGES,
                                alpha=alpha, beta=beta)


# -- scan has no mockup_cost entry (the paper lists it without a §3
#    analysis); charge the emulation's actual all-gather volumes ---------

def cost_native_scan(n: int, N: int, c_bytes: float, cfg) -> float:
    """Direct algorithm: gather the whole communicator, (p-1)·c moved."""
    p = max(n * N, 1)
    alpha, beta = _level(N, cfg)
    return _lg(p) * alpha + (p - 1) * c_bytes * beta


def cost_lane_scan(n: int, N: int, c_bytes: float, cfg) -> float:
    """Scan(node) + striped Exscan(lane) + AG(node) emulation volumes; the
    lane phase is an untiled all-gather of the c/n stripe, (N-1)·c/n."""
    hw = get_hw()
    t_node = 2 * _lg(n) * hw.alpha_node \
        + 2 * (n - 1) * c_bytes / hw.node_bw          # node scan + final AG
    t_lane = _lg(N) * hw.alpha_lane \
        + (N - 1) * (c_bytes / max(n, 1)) / hw.lane_bw
    return t_node + t_lane


def cost_lane_scatter(n: int, N: int, c_bytes: float, cfg) -> float:
    """Root-replicated lane scatter: the only communication is the lane
    scatter of the local c/n stripe."""
    hw = get_hw()
    stripe = c_bytes / max(n, 1)
    return _lg(N) * hw.alpha_lane \
        + (N - 1) / max(N, 1) * stripe / hw.lane_bw
