"""repro_torch.core — the paper's contribution on ``torch.distributed``:
multi-lane collective decomposition over node and lane process groups.

Counterpart of ``repro.core``: ``lane`` (the topology), ``collectives``
(Listings 1-6 and the natives), ``pipeline`` (§5), ``costmodel`` (§3/§5),
``guidelines`` (the paper's timing protocol) and ``ref`` (numpy
oracles).
"""
from .lane import LaneTopology
from .collectives import (
    allreduce_lane, reduce_scatter_lane, allgather_lane, bcast_lane,
    alltoall_lane, reduce_lane, gather_lane, scatter_lane, scan_lane,
    native_allreduce, native_allgather, native_reduce_scatter,
    native_alltoall, native_scan,
)
from .pipeline import (
    pipelined_bcast_lane, pipelined_reduce_lane, pipelined_allgather_lane,
    pipeline_steps, allreduce_pipeline_steps, allgather_pipeline_steps,
)
from .costmodel import (
    CollectiveCost, mockup_cost, klane_time, HW, get_hw, set_hw,
    optimal_num_buckets, bucket_pipeline_time, optimal_prefetch_blocks,
)
from .guidelines import (
    time_fn, time_fn_samples, median_us, GuidelineResult, check_guideline,
)

__all__ = [
    "LaneTopology",
    "allreduce_lane", "reduce_scatter_lane", "allgather_lane", "bcast_lane",
    "alltoall_lane", "reduce_lane", "gather_lane", "scatter_lane",
    "scan_lane",
    "native_allreduce", "native_allgather", "native_reduce_scatter",
    "native_alltoall", "native_scan",
    "pipelined_bcast_lane", "pipelined_reduce_lane",
    "pipelined_allgather_lane", "pipeline_steps",
    "allreduce_pipeline_steps", "allgather_pipeline_steps",
    "CollectiveCost", "mockup_cost", "klane_time", "HW", "get_hw", "set_hw",
    "optimal_num_buckets", "bucket_pipeline_time", "optimal_prefetch_blocks",
    "time_fn", "time_fn_samples", "median_us", "GuidelineResult",
    "check_guideline",
]
