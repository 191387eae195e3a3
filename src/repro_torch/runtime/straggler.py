"""Straggler mitigation: a bounded-staleness quorum on the lane hop.

Counterpart of ``repro.runtime.straggler``, on ``torch.distributed``'s
lane group.

Across many pods the hop between nodes is where a straggler shows (one
slow host delays the whole allreduce).  The paper's decomposition
isolates exactly that hop, the lane allreduce on 1/n of the payload,
which makes it the natural place for a quorum: pods that miss the
deadline contribute zero and the mean is rescaled by the number of
contributors.  The node reduce-scatter and all-gather stay whole.

The quorum is a 0/1 ``contributing`` bit of THIS process's pod (its entry
of the watchdog's mask, ``runtime.watchdog``), a float or a 0-dim tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.lane import LaneTopology

__all__ = ["quorum_stage", "quorum_mean"]


def _bit(contributing, device) -> torch.Tensor:
    """This pod's bit as a 1-element f32 tensor on ``device``."""
    return torch.as_tensor(contributing, dtype=torch.float32) \
        .reshape(1).to(device)


def _live(c: torch.Tensor, topo: LaneTopology) -> torch.Tensor:
    """The live pod count over the lane group, at least 1."""
    den = c.clone()
    dist.all_reduce(den, group=topo.lane_group)
    return den.clamp_(min=1.0)


def quorum_stage(topo: LaneTopology, contributing, *, device=None):
    """Bucket-schedule stage: the quorum allreduce-mean over the lane.

    The ``lane_quorum`` grad sync puts this stage in place of the plain
    lane allreduce inside the same RS(node) -> AR(lane) -> AG(node)
    schedule (``optim.gradsync.bucket_schedule``): this process's stripe
    of each bucket is multiplied by its pod's bit, summed over the lane
    group in place and divided by the live count.  The divisor is one
    scalar all-reduce for the whole schedule, made here, not one per
    bucket.  With every bit 1 the stage computes sum(x·1)/N, which on a
    power-of-two pod count is bit-identical to the ``lane`` strategy's
    sum followed by its deferred division.  ``device``: where the
    payload lives (default: the bit's device)."""
    from repro_torch.optim.gradsync import _stage, _stripe
    c = _bit(contributing, device)
    den = _live(c, topo)

    def stage(v):
        s = _stripe(v, topo)
        s.mul_(c.to(s.dtype))
        work = dist.all_reduce(s, group=topo.lane_group, async_op=True)

        def finish():
            work.wait()
            s.div_(den.to(s.dtype))
        return finish
    return _stage("ar_lane_quorum", stage)


def quorum_mean(x: torch.Tensor, topo: LaneTopology, contributing):
    """Mean of ``x`` over the lane (pod) level counting only contributors.

    ``x``: this process's value (any shape); ``contributing``: its pod's
    0/1 bit.  Non-contributors are zeroed and the divisor is the live
    count (at least 1), so a dropped pod changes the result exactly as if
    its rows were skipped, which the (seed, step)-keyed data pipeline can
    replay.  Returns a new tensor."""
    c = _bit(contributing, x.device)
    num = (x * c.to(x.dtype).reshape(())).reshape(-1)
    dist.all_reduce(num, group=topo.lane_group)
    return (num / _live(c, topo).to(x.dtype)).reshape(x.shape)
