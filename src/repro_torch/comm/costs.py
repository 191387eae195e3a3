"""Cost functions for auto-dispatch — the §3/§5 model per registration.

Counterpart of ``repro.comm.costs``.  Every cost function has the
registry's cost signature ``(n, N, payload_bytes, cfg) -> seconds`` with
n = processes per node (GPUs per host), N = nodes (hosts).  The
constants are the active ones (``core.costmodel.get_hw``).

Two volume functions hold the costs to what the cells issue (lanelint,
``repro_torch.analysis``):

* ``lowered_wire_volumes`` — the per-level wire bytes one execution of
  a cell moves on its busiest process, derived from the port's own
  calls under the recorder's conventions (``analysis/footprint.py``).
  It keeps ``repro``'s name; ``repro``'s is the algebra of its compiled
  HLO.  Where the port issues what ``repro`` lowers the two are equal;
  where a cell is built otherwise (the rooted natives and lane phases,
  whole-world natives where XLA splits over the mesh axes, the pipelines
  without warm-up traffic) the form below is the port's.
* ``assumed_volumes`` — what the matching cost function charges, and the
  bound within which R3 holds it to the issued volumes; ``repro``'s,
  since the cost functions are.

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
    "cost_lane_scatter", "lowered_wire_volumes", "assumed_volumes",
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


# ---------------------------------------------------------------------------
# lanelint's volume algebra (R2 and R3)
# ---------------------------------------------------------------------------

#: base R3 bound: a cost model within 4× of what its cell issues still
#: ranks the native/lane/pipelined alternatives in the regimes the paper
#: needs
_R3_BASE_BOUND = 4.0


def lowered_wire_volumes(collective: str, strategy: str, *, n: int,
                         N: int, payload_bytes: float,
                         num_blocks=None, num_buckets=None):
    """Per-level wire bytes {level: bytes} one execution of the cell
    moves on its busiest process (each level's maximum over the
    processes; every process of a symmetric cell moves it), or None for
    a cell without a closed form.  ``payload_bytes`` is one process's
    input; the sweep's payloads divide every split, so nothing pads but
    ``kv_splice/lane``'s leaf.

    What the port issues, in ``analysis/footprint.py``'s wire units:

    * whole-world natives are one call over the world, all "global";
    * the rooted cells (bcast, reduce, gather, scatter, and
      ``kv_splice/lane``'s lane bcast) call the rooted collectives;
      node phases a cell runs on the root lane alone count on those
      processes;
    * the pipelines move only the blocks they hold: the allreduce's
      B+2 steps issue B node reduce-scatters, B stripe rings of N-1 hops
      and B node all-gathers; the rooted rings send each block once down
      the lane."""
    import math
    c = float(payload_bytes)
    p = max(n * N, 1)
    if collective == "moe_route":
        collective = "alltoall"          # the same exchange, the same calls
    key = (collective, strategy)

    if key in (("allreduce", "native"), ("grad_sync", "native"),
               ("kv_splice", "native")):
        return {"global": 2 * (p - 1) / p * c}
    if key in (("allreduce", "lane"), ("grad_sync", "lane"),
               ("grad_sync", "lane_quorum")):
        # the quorum's one scalar divisor all-reduce rides inside R2's
        # absolute tolerance
        return {"node": 2 * (n - 1) / n * c,
                "lane": 2 * (N - 1) / N * c / n}
    if key in (("allreduce", "lane_pipelined"),
               ("grad_sync", "lane_pipelined")):
        # B blocks: RS(node) + AG(node) each, and the stripe's ring of
        # N-1 sends; no warm-up or drain step sends anything
        return {"node": 2 * (n - 1) / n * c, "lane": (N - 1) * c / n}
    if key == ("grad_sync", "lane_zero1"):
        return {"node": (n - 1) / n * c,
                "lane": 2 * (N - 1) / N * c / n}
    if key == ("grad_sync", "lane_zero3"):
        return {"node": (n - 1) / n * c, "lane": (N - 1) * c / p}
    if key == ("grad_sync", "lane_int8"):
        # RS(node) + AG(lane) of each bucket's packed stripe (whole
        # 1024-element chunks, 1024 int8 B + one f32 scale each) +
        # AG(node)
        K = num_buckets or 1
        chunks = max(1, math.ceil(c / 4 / K / n / 1024))
        return {"node": 2 * (n - 1) / n * c,
                "lane": (N - 1) * K * 1028 * chunks}
    if key == ("reduce_scatter", "native"):
        return {"global": (p - 1) * c / p}
    if key == ("reduce_scatter", "lane"):
        return {"node": (n - 1) / n * c, "lane": (N - 1) * c / p}
    if key in (("allgather", "native"), ("scan", "native")):
        return {"global": (p - 1) * c}
    if key in (("allgather", "lane"), ("gather", "lane"),
               ("prefetch_allgather", "lane_pipelined"),
               ("prefetch_allgather", "blocking")):
        # AG or Gather(lane) of c, then of the N·c (on the root lane
        # for gather) over the node
        return {"lane": (N - 1) * c, "node": (n - 1) * N * c}
    if key == ("alltoall", "native"):
        return {"global": (p - 1) / p * c}
    if key == ("alltoall", "lane"):
        return {"lane": (N - 1) / N * c, "node": (n - 1) / n * c}
    if key == ("scan", "lane"):
        # AG(node, full) for the node scan + AG(lane) of the c/n stripe
        # of totals + AG(node) of the stripe
        return {"node": (n - 1) * c + (n - 1) / n * c,
                "lane": (N - 1) * c / n}
    if key in (("bcast", "native"), ("reduce", "native")):
        return {"global": c}
    if key == ("gather", "native"):
        return {"global": (p - 1) * c}
    if key == ("scatter", "native"):
        return {"global": (p - 1) * c / p}
    if key == ("bcast", "lane"):
        # the root-replicated stripe broadcast down each lane + AG(node)
        return {"node": (n - 1) / n * c, "lane": c / n}
    if key == ("kv_splice", "lane"):
        # bcast/lane of the flattened leaf zero-padded to n | elements
        pad = math.ceil(c / 4 / n) * n * 4
        return {"node": (n - 1) / n * pad, "lane": pad / n}
    if key == ("reduce", "lane"):
        # RS(node) + Reduce(lane) of the stripe + Gather(node) of the
        # stripes to the root, on the root lane
        return {"node": 2 * (n - 1) / n * c, "lane": c / n}
    if key == ("scatter", "lane"):
        # root-replicated: the root lane's stripe scattered down the lane
        return {"lane": (N - 1) * c / p}
    if key == ("bcast", "lane_pipelined"):
        # each block once down the ring (the last lane rank sends none),
        # and AG(node) of every block
        return {"lane": c / n, "node": (n - 1) / n * c}
    if key == ("reduce", "lane_pipelined"):
        # each block's f32 partial once up the ring (the root lane sends
        # none); RS(node) of every block, AG(node) of the root's stripes
        return {"lane": c / n, "node": 2 * (n - 1) / n * c}
    return None


def assumed_volumes(collective: str, strategy: str, *, n: int, N: int,
                    payload_bytes: float, num_blocks=None,
                    num_buckets=None):
    """({level-or-"total": bytes}, bound) the registered cost function
    charges, or None when the cell carries no cost (auto_ok=False cells
    are dispatched explicitly; there is no ranking to keep honest).

    "total" compares against the SUM of the issued levels: native costs
    charge a single slowest-level volume.  The bound widens only for
    documented convention gaps:

    * alltoall (both) and scatter/native use the §3 per-destination-block
      convention (mock-up ``c`` = one block) while dispatch passes the
      whole local buffer → ratio p by construction.
    * pipelined cells charge only the bottleneck lane stripe; the node
      stages ride under it (§5 simultaneity), and the lane ring moves
      (N-1)× the stripe the bucket model prices → ratio up to N-1.
    """
    c = float(payload_bytes)
    p = max(n * N, 1)
    if collective == "moe_route":
        collective = "alltoall"
    key = (collective, strategy)
    no_cost = {
        ("bcast", "lane_pipelined"), ("reduce", "lane_pipelined"),
        ("grad_sync", "lane_quorum"), ("grad_sync", "lane_int8"),
        ("grad_sync", "lane_zero1"), ("grad_sync", "lane_zero3"),
        ("prefetch_allgather", "blocking"),
        ("kv_splice", "native"), ("kv_splice", "lane"),
    }
    if key in no_cost:
        return None

    if strategy == "native" and collective != "scan":
        coll = "allreduce" if collective == "grad_sync" else collective
        vol = mockup_cost(coll, n, N, c).optimal_vol
        bound = _R3_BASE_BOUND
        if collective in ("alltoall", "scatter"):
            bound *= p                       # per-destination-block gap
        return {"total": vol}, bound
    if strategy == "lane" and collective not in ("scan", "scatter"):
        coll = "allreduce" if collective == "grad_sync" else collective
        mc = mockup_cost(coll, n, N, c)
        bound = _R3_BASE_BOUND * (p if collective == "alltoall" else 1)
        return {"node": mc.vol_node, "lane": mc.vol_lane}, bound
    if key == ("scan", "native"):
        return {"total": (p - 1) * c}, _R3_BASE_BOUND
    if key == ("scan", "lane"):
        return {"node": 2 * (n - 1) * c,
                "lane": (N - 1) * c / n}, _R3_BASE_BOUND
    if key == ("scatter", "lane"):
        return {"lane": (N - 1) / N * (c / n)}, _R3_BASE_BOUND
    if key in (("allreduce", "lane_pipelined"),
               ("grad_sync", "lane_pipelined")):
        # the bucket model charges ≈ the c/n stripe once on the lane;
        # the ring moves (N-1)× that and the node stages ride under
        return {"lane": c / n}, _R3_BASE_BOUND * max(N - 1, 1)
    if key == ("prefetch_allgather", "lane_pipelined"):
        return {"lane": c}, _R3_BASE_BOUND * max(N - 1, 1)
    return None
