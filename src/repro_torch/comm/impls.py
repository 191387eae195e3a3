"""Registered implementations of every LaneComm collective.

Counterpart of ``repro.comm.impls``: each (collective, strategy) cell is
one ``@register_impl`` registration wrapping the §3 mock-ups
(:mod:`repro_torch.core.collectives`), the §5 pipelined constructions
(:mod:`repro_torch.core.pipeline`) and the bucketed gradient sync
(:mod:`repro_torch.optim.gradsync`).

Registration legend per collective:

  native           one call over the whole communicator (the baseline the
                   paper's decompositions are measured against); the
                   rooted ones are torch.distributed's rooted collectives
  lane             full-lane mock-up (Listings 1-6)
  lane_pipelined   §5 pipelined construction (allreduce/bcast/reduce;
                   bcast/reduce rings are rooted at lane 0, so they are
                   never auto-selected)
  grad_sync        the training collective: native / lane /
                   lane_pipelined / lane_int8 / lane_quorum, each in
                   place; lane_zero1 and lane_zero3 return (this
                   process's flat shard, spec) for the sharded optimizers
  prefetch_allgather
                   the ZeRO-3 per-layer weight re-gather: the §5
                   pipelined AG(lane)→AG(node), or the monolithic
                   blocking comparator
  kv_splice        the serving KV distribution into a slot-sharded
                   cache: a mask-to-root all-reduce (native) or the lane
                   bcast (lane), then the local splice

The cells of a later ROADMAP item (``moe_route``: item 10) stay
unregistered; resolving one raises ``NotImplementedError`` naming its
item (``registry.UNPORTED``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.core import collectives as C
from repro_torch.core.lane import LaneTopology
from repro_torch.core.costmodel import optimal_prefetch_blocks
from repro_torch.core.pipeline import (
    _pipelined_allreduce_lane, pipelined_allgather_lane,
    pipelined_allreduce_, pipelined_bcast_lane, pipelined_reduce_lane,
)
from repro_torch.optim.gradsync import (
    _ag_node, _ar_lane, _ar_lane_int8, _flatten_bucket, _rs_node,
    _rs_lane as _rs_lane_stage, _unflatten_bucket, bucket_schedule,
    resolve_num_buckets, zero1_param_shard, zero3_param_shard,
    zero3_unshard,
)

from . import costs
from .layout import register_param_layout
from .registry import register_impl

__all__ = []  # everything is reached through the registry


# ---------------------------------------------------------------------------
# feasibility predicates (leading-dim divisibility of the §3 mock-ups)
# ---------------------------------------------------------------------------

def _div_n(n, N, lead):
    return lead % max(n, 1) == 0


def _div_p(n, N, lead):
    return lead % max(n * N, 1) == 0


def _root(topo: LaneTopology, root_lane: int, root_node: int):
    """(world rank of the root, whether this process is it)."""
    g = root_lane * topo.n() + root_node
    return topo.rank_of(g), topo.global_rank() == g


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

@register_impl("allreduce", "native", cost=costs.native_cost("allreduce"))
def _allreduce_native(comm, x):
    return C.native_allreduce(x, comm.topo)


@register_impl("allreduce", "lane", cost=costs.lane_cost("allreduce"),
               feasible=_div_n)
def _allreduce_lane(comm, x):
    return C.allreduce_lane(x, comm.topo)


@register_impl("allreduce", "lane_pipelined",
               cost=costs.cost_pipelined_allreduce, feasible=_div_n)
def _allreduce_pipelined(comm, x, *, num_blocks=None):
    """§5 pipelined allreduce; num_blocks None = cost-model K shrunk to
    the nearest divisor of the per-process block count (explicit values
    must divide)."""
    n = comm.topo.n()
    lead = x.shape[0]
    if num_blocks is None:
        B = resolve_num_buckets(lead, n, comm.cfg.buckets)
        while lead % (B * n):
            B -= 1
        num_blocks = max(B, 1)
    return _pipelined_allreduce_lane(x, comm.topo, num_blocks=num_blocks)


# ---------------------------------------------------------------------------
# reduce_scatter / allgather / alltoall / scan
# ---------------------------------------------------------------------------

@register_impl("reduce_scatter", "native",
               cost=costs.native_cost("reduce_scatter"), feasible=_div_p)
def _rs_native(comm, x):
    return C.native_reduce_scatter(x, comm.topo)


@register_impl("reduce_scatter", "lane",
               cost=costs.lane_cost("reduce_scatter"), feasible=_div_p)
def _rs_lane(comm, x):
    return C.reduce_scatter_lane(x, comm.topo)


@register_impl("allgather", "native", cost=costs.native_cost("allgather"))
def _ag_native(comm, x):
    return C.native_allgather(x, comm.topo)


@register_impl("allgather", "lane", cost=costs.lane_cost("allgather"))
def _ag_lane(comm, x, *, reorder=True):
    return C.allgather_lane(x, comm.topo, reorder=reorder)


@register_impl("alltoall", "native", cost=costs.native_cost("alltoall"),
               feasible=_div_p)
def _a2a_native(comm, x):
    return C.native_alltoall(x, comm.topo)


@register_impl("alltoall", "lane", cost=costs.lane_cost("alltoall"),
               feasible=_div_p)
def _a2a_lane(comm, x):
    return C.alltoall_lane(x, comm.topo)


@register_impl("scan", "native", cost=costs.cost_native_scan)
def _scan_native(comm, x):
    return C.native_scan(x, comm.topo)


@register_impl("scan", "lane", cost=costs.cost_lane_scan, feasible=_div_n)
def _scan_lane(comm, x):
    return C.scan_lane(x, comm.topo)


# ---------------------------------------------------------------------------
# rooted collectives (zeros off the root, as in repro)
# ---------------------------------------------------------------------------

@register_impl("bcast", "native", cost=costs.native_cost("bcast"))
def _bcast_native(comm, x, *, root_lane=0, root_node=0,
                  root_replicated=True):
    """One broadcast over the whole communicator from the root."""
    src, _ = _root(comm.topo, root_lane, root_node)
    out = x.contiguous().clone()
    dist.broadcast(out, src=src, group=comm.topo.group)
    return out


@register_impl("bcast", "lane", cost=costs.lane_cost("bcast"),
               feasible=_div_n)
def _bcast_lane(comm, x, *, root_lane=0, root_node=0, root_replicated=True):
    return C.bcast_lane(x, comm.topo, root_lane=root_lane,
                        root_node=root_node, root_replicated=root_replicated)


@register_impl("bcast", "lane_pipelined", auto_ok=False, feasible=_div_n)
def _bcast_pipelined(comm, x, *, num_blocks, root_lane=0):
    return pipelined_bcast_lane(x, comm.topo, num_blocks=num_blocks,
                                root_lane=root_lane)


@register_impl("reduce", "native", cost=costs.native_cost("reduce"))
def _reduce_native(comm, x, *, root_lane=0, root_node=0):
    dst, is_root = _root(comm.topo, root_lane, root_node)
    out = x.contiguous().clone()
    dist.reduce(out, dst=dst, group=comm.topo.group)
    return out if is_root else out.zero_()


@register_impl("reduce", "lane", cost=costs.lane_cost("reduce"),
               feasible=_div_n)
def _reduce_lane(comm, x, *, root_lane=0, root_node=0):
    return C.reduce_lane(x, comm.topo, root_lane=root_lane,
                         root_node=root_node)


@register_impl("reduce", "lane_pipelined", auto_ok=False, feasible=_div_n)
def _reduce_pipelined(comm, x, *, num_blocks, root_lane=0):
    return pipelined_reduce_lane(x, comm.topo, num_blocks=num_blocks,
                                 root_lane=root_lane)


@register_impl("gather", "native", cost=costs.native_cost("gather"))
def _gather_native(comm, x, *, root_lane=0, root_node=0):
    topo = comm.topo
    dst, is_root = _root(topo, root_lane, root_node)
    m = x.shape[0]
    out = x.new_zeros((topo.p() * m, *x.shape[1:]))
    dist.gather(x.contiguous(), list(out.split(m)) if is_root else None,
                dst=dst, group=topo.group)
    return out


@register_impl("gather", "lane", cost=costs.lane_cost("gather"))
def _gather_lane(comm, x, *, root_lane=0, root_node=0):
    return C.gather_lane(x, comm.topo, root_lane=root_lane,
                         root_node=root_node)


@register_impl("scatter", "native", cost=costs.native_cost("scatter"),
               feasible=_div_p)
def _scatter_native(comm, x, *, root_lane=0, root_node=0,
                    root_replicated=True):
    """One scatter over the whole communicator from the root."""
    topo = comm.topo
    p = topo.p()
    if x.shape[0] % p:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by p={p}")
    m = x.shape[0] // p
    src, is_root = _root(topo, root_lane, root_node)
    out = x.new_empty((m, *x.shape[1:]))
    dist.scatter(out, list(x.contiguous().split(m)) if is_root else None,
                 src=src, group=topo.group)
    return out


@register_impl("scatter", "lane", cost=costs.cost_lane_scatter,
               feasible=_div_p)
def _scatter_lane(comm, x, *, root_lane=0, root_node=0,
                  root_replicated=True):
    return C.scatter_lane(x, comm.topo, root_lane=root_lane,
                          root_node=root_node,
                          root_replicated=root_replicated)


# ---------------------------------------------------------------------------
# grad_sync — the training collective, in place on the gradient leaves
# ---------------------------------------------------------------------------

def _grad_prep(comm, grads, shard_ways: int, num_buckets: int):
    """Shared bucketing prologue: resolve K, flatten+pad to K·shard_ways."""
    total = sum(l.numel() for l in _tree.leaves(grads))
    K = resolve_num_buckets(total, shard_ways, num_buckets)
    flat, spec = _flatten_bucket(grads, pad_to=K * shard_ways)
    return K, flat, spec


@register_impl("grad_sync", "native", cost=costs.native_cost("allreduce"))
def _gs_native(comm, grads, *, num_buckets=0):
    """One allreduce per leaf, in the leaf's dtype, then the mean."""
    topo = comm.topo
    leaves = _tree.leaves(grads)
    works = [dist.all_reduce(g, group=topo.group, async_op=True)
             for g in leaves]
    for w, g in zip(works, leaves):
        w.wait()
        g.div_(topo.p())
    return grads


@register_impl("grad_sync", "lane", cost=costs.lane_cost("allreduce"))
def _gs_lane(comm, grads, *, num_buckets=0):
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.n(), num_buckets)
    bucket_schedule(flat, K, (_rs_node(topo), _ar_lane(topo), _ag_node(topo)))
    return _unflatten_bucket(flat.div_(topo.p()), spec)


@register_impl("grad_sync", "lane_pipelined",
               cost=costs.cost_pipelined_allreduce)
def _gs_pipelined(comm, grads, *, num_buckets=0):
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.n(), num_buckets)
    pipelined_allreduce_(flat, topo, num_blocks=K)
    return _unflatten_bucket(flat.div_(topo.p()), spec)


@register_impl("grad_sync", "lane_quorum", auto_ok=False, feasible=_div_n)
def _gs_quorum(comm, grads, *, num_buckets=0, contributing=None):
    """Quorum-degraded lane sync: the lane hop becomes a masked mean.

    The same bucket schedule as ``lane``, RS(node) -> AR(lane) ->
    AG(node), in place on the flat f32 buffer, but the lane allreduce is
    ``runtime.straggler``'s quorum stage: THIS pod's ``contributing`` bit
    (0/1, from the host-side watchdog) zeroes its stripe and the divisor
    is the live pod count instead of the lane size, so a masked pod's
    gradient cannot reach the result: the step equals the same step with
    that pod's rows skipped.  ``contributing=None`` is a full quorum,
    bit-identical to ``lane`` on power-of-two pod counts.  Never
    auto-selected: with a pod masked it is another estimator (fewer
    samples)."""
    from repro_torch.runtime.straggler import quorum_stage
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.n(), num_buckets)
    bucket_schedule(flat, K, (
        _rs_node(topo),
        quorum_stage(topo, 1.0 if contributing is None else contributing,
                     device=flat.device),
        _ag_node(topo)))
    # the quorum stage already divided by the live lane count; only the
    # node level's factor is left
    return _unflatten_bucket(flat.div_(topo.n()), spec)


@register_impl("grad_sync", "lane_int8", auto_ok=False)
def _gs_int8(comm, grads, *, num_buckets=0):
    """Lossy (int8 lane hop): opt-in only, never auto-selected."""
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.n(), num_buckets)
    bucket_schedule(flat, K, (_rs_node(topo), _ar_lane_int8(topo),
                              _ag_node(topo)))
    return _unflatten_bucket(flat.div_(topo.p()), spec)


@register_impl("grad_sync", "lane_zero1", auto_ok=False)
def _gs_zero1(comm, grads, *, num_buckets=0):
    """Returns (node-sharded flat, spec): RS(node) → AR(lane) per bucket
    and no trailing all-gather; the caller owns it, moved past the
    optimizer (``launch/steps.py``)."""
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.n(), num_buckets)
    bucket_schedule(flat, K, (_rs_node(topo), _ar_lane(topo)))
    return zero1_param_shard(flat, topo, K).div_(topo.p()), spec


@register_impl("grad_sync", "lane_zero3", auto_ok=False)
def _gs_zero3(comm, grads, *, num_buckets=0):
    """Returns (1/p-sharded flat, spec): RS(node) → RS(lane) per bucket,
    the ``zero3_param_shard`` layout; the layer prefetch re-gathers in the
    next forward (``models/blockstack.py``)."""
    topo = comm.topo
    K, flat, spec = _grad_prep(comm, grads, topo.p(), num_buckets)
    bucket_schedule(flat, K, (_rs_node(topo), _rs_lane_stage(topo)))
    return zero3_param_shard(flat, topo, K).div_(topo.p()), spec


# the replicated train step runs the exact, int8 and quorum syncs and the
# auto-dispatched one: params and moments stay ordinary trees, identical
# on every rank; the ZeRO steps shard the moments (zero1) or the
# parameters too (zero3)
for _s in ("native", "lane", "lane_pipelined", "lane_int8", "lane_quorum",
           "auto"):
    register_param_layout(_s, "replicated")
register_param_layout("lane_zero1", "zero1")
register_param_layout("lane_zero3", "zero3")


# ---------------------------------------------------------------------------
# prefetch_allgather — the ZeRO-3 per-layer weight re-gather
# ---------------------------------------------------------------------------

def _resolve_blocks(comm, lead: int, num_blocks) -> int:
    """B for a per-process stripe of ``lead`` f32 rows.

    An EXPLICIT num_blocks is strict: it names a shard layout the caller
    already committed to, so an indivisible value raises downstream.
    Only the auto path (None) may shrink: cfg.prefetch_blocks (-1 → 1,
    the blocking control) or the cost model on the stripe bytes, clamped
    to a divisor of lead."""
    if num_blocks is not None:
        return num_blocks
    ov = comm.cfg.prefetch_blocks
    if ov > 0:
        B = ov
    elif ov < 0:
        B = 1
    else:
        B = optimal_prefetch_blocks(lead * 4)
    B = max(1, min(B, lead))
    while lead % B:
        B -= 1
    return B


@register_impl("prefetch_allgather", "lane_pipelined",
               cost=costs.cost_pipelined_allgather)
def _prefetch_pipelined(comm, shard, *, num_blocks=None):
    B = _resolve_blocks(comm, shard.shape[0], num_blocks)
    return pipelined_allgather_lane(shard, comm.topo, num_blocks=B)


@register_impl("prefetch_allgather", "blocking", auto_ok=False,
               probe_ok=True)
def _prefetch_blocking(comm, shard, *, num_blocks=None):
    """Monolithic AG(lane)→AG(node) of the whole shard: the comparator
    of the pipelined gather, never auto-selected."""
    B = _resolve_blocks(comm, shard.shape[0], num_blocks)
    return zero3_unshard(shard, comm.topo, B)


# ---------------------------------------------------------------------------
# kv_splice: the serving KV / state distribution collective
# ---------------------------------------------------------------------------
#
# Continuous batching with the slots sharded over the processes needs one
# communication: after a batch-1 prefill (run on every process, the
# root's copy canonical) the fresh cache leaf must land in slot ``slot``
# of the slot-sharded cache, which lives on exactly one process.  That is
# a rooted broadcast of the leaf and a local splice.  Slot ownership
# follows the global rank, as ``scatter``'s blocks: process r owns slots
# [r·B_local, (r+1)·B_local).

def _splice_local(comm, big, small, slot: int, batch_axis: int):
    """Write ``small`` (batch 1 along ``batch_axis``) into global slot
    ``slot`` of this process's block of slots ``big``, in place, when it
    owns the slot; leave ``big`` as it is otherwise.  Returns ``big``."""
    B_local = big.shape[batch_axis]
    local = int(slot) - comm.topo.global_rank() * B_local
    if 0 <= local < B_local:
        big.narrow(batch_axis, local, 1).copy_(small)
    return big


@register_impl("kv_splice", "native", auto_ok=False)
def _kv_splice_native(comm, big, *, small, slot, batch_axis=1,
                      root_lane=0, root_node=0):
    """One-shot baseline: a mask-to-root all-reduce of the whole leaf (the
    SPMD emulation ``repro``'s ``bcast/native`` charges), then the local
    splice."""
    _, mine = _root(comm.topo, root_lane, root_node)
    small = small.to(big.dtype, copy=True)
    if not mine:
        small.zero_()
    dist.all_reduce(small, group=comm.topo.group)
    return _splice_local(comm, big, small, slot, batch_axis)


@register_impl("kv_splice", "lane", auto_ok=False)
def _kv_splice_lane(comm, big, *, small, slot, batch_axis=1,
                    root_lane=0, root_node=0):
    """Decomposed variant: the leaf flattened, zero-padded to a multiple
    of n, broadcast through the §3 lane bcast (the root node's stripes,
    n lane broadcasts, an all-gather on every node), then spliced
    locally."""
    topo = comm.topo
    flat = small.to(big.dtype).reshape(-1)
    pad = (-flat.shape[0]) % max(topo.n(), 1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = C.bcast_lane(flat, topo, root_lane=root_lane, root_node=root_node,
                       root_replicated=True)
    small = out[:small.numel()].reshape(small.shape)
    return _splice_local(comm, big, small, slot, batch_axis)


def grad_sync_buckets(comm, grads, num_buckets=None) -> int:
    """The K that ``comm.grad_sync(grads)`` resolves (for reports)."""
    nb = comm.cfg.buckets if num_buckets is None else num_buckets
    total = sum(l.numel() for l in _tree.leaves(grads))
    return resolve_num_buckets(total, comm.topo.n(), nb)

