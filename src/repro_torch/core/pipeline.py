"""Paper §5, Proposition 1: pipelined k-lane constructions on process
groups.

Counterpart of ``repro.core.pipeline``.  The construction: replicate a
single-ported linear pipeline over p/k processors k times (one replica
per on-node process), stripe the payload 1/k per replica, and close every
pipeline step with a k-clique exchange on the node so each node
reassembles full blocks as they arrive.

The lane ring is ``dist.batch_isend_irecv`` on the lane group; the clique
exchange is a collective on the node group.  Within one pipeline step the
node and the lane operation have no data dependence, so both are issued
``async_op=True`` on their separate groups and waited for together at
the end of the step: the port's form of the k-lane model's simultaneity.
At N=1 there is no lane ring and nothing is sent.

As in ``repro``, the root node's processes are all handed the same buffer
(root replication), so the paper's special root steps vanish.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .lane import LaneTopology

__all__ = ["pipelined_bcast_lane", "pipelined_reduce_lane",
           "pipelined_allgather_lane", "pipelined_reduce_scatter_lane_",
           "pipeline_steps",
           "allreduce_pipeline_steps", "allgather_pipeline_steps",
           "ALLREDUCE_STAGES", "ALLGATHER_STAGES"]


def pipeline_steps(num_blocks: int, N: int) -> int:
    """Ring length: the last block reaches the last node at step N-2+B."""
    return num_blocks + N - 1


ALLREDUCE_STAGES = 3     # RS(node) → ring-AR(lane) → AG(node)

ALLGATHER_STAGES = 2     # AG(lane) → AG(node)


def allreduce_pipeline_steps(num_blocks: int) -> int:
    """Steps of the pipelined allreduce: B blocks through 3 stages."""
    return num_blocks + ALLREDUCE_STAGES - 1


def allgather_pipeline_steps(num_blocks: int) -> int:
    """Steps of the pipelined allgather: B blocks through 2 stages."""
    return num_blocks + ALLGATHER_STAGES - 1


def _wait(works) -> None:
    for w in works:
        if w is not None:
            w.wait()


def _p2p(topo: LaneTopology, send=None, to=None, recv=None, frm=None):
    """Post a send to lane rank ``to`` and/or a receive from lane rank
    ``frm`` on the lane group; returns the works to wait for."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, topo.lane_peer(to),
                              topo.lane_group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, topo.lane_peer(frm),
                              topo.lane_group))
    return dist.batch_isend_irecv(ops) if ops else []


def _stripe(blk, i: int, s: int):
    return blk[i * s:(i + 1) * s]


def pipelined_bcast_lane(x, topo: LaneTopology, *, num_blocks: int,
                         root_lane: int = 0):
    """Pipelined k-lane broadcast of the root lane's node-replicated buffer.

    x: (c, ...) — meaningful on processes with lane_rank == root_lane (all
    of them, node-replicated); other processes' x is ignored.  Requires
    c % (num_blocks * n) == 0.  At step t, lane rank j holds block t - j:
    it forwards it to lane rank j+1 and, at the same time, all-gathers it
    over its node.  Returns the broadcast buffer on every process.
    """
    if root_lane != 0:
        raise NotImplementedError("ring is rooted at lane rank 0")
    n, N = topo.n(), topo.N()
    c = x.shape[0]
    B = num_blocks
    if c % (B * n):
        raise ValueError(f"payload {c} not divisible by num_blocks*n={B * n}")
    s = c // (B * n)
    rest = x.shape[1:]
    i, j = topo.node_rank(), topo.lane_rank()
    stripes = x.reshape(B, n, s, *rest)[:, i]     # (B, s, ...): own stripes
    out = x.new_empty((B, n * s, *rest))
    buf = None                                    # received last step
    for t in range(pipeline_steps(B, N)):
        b = t - j                                 # block held at step t
        held = 0 <= b < B
        cur = (stripes[b].contiguous() if j == 0 else buf) if held else None
        nxt = x.new_empty((s, *rest)) if j > 0 and 0 <= b + 1 < B else None
        works = _p2p(topo, send=cur if held and j + 1 < N else None,
                     to=j + 1, recv=nxt, frm=j - 1)
        if held:                                  # the node clique exchange
            works.append(dist.all_gather_into_tensor(
                out[b], cur, group=topo.node_group, async_op=True))
        _wait(works)
        buf = nxt
    return out.reshape(c, *rest)


def pipelined_reduce_lane(x, topo: LaneTopology, *, num_blocks: int,
                          root_lane: int = 0):
    """Pipelined k-lane REDUCE — the dual of the broadcast construction.

    Blocks flow down each lane ring toward the root lane, accumulating the
    lane dimension; each step's node operation is a reduce-scatter that
    folds the node dimension into the per-process stripe.  Steps: B+N-1.
    Returns the full sum on the process (root_lane, node rank 0), zeros
    elsewhere — ``repro``'s convention.  Sums in f32.
    """
    if root_lane != 0:
        raise NotImplementedError("ring is rooted at lane rank 0")
    n, N = topo.n(), topo.N()
    c = x.shape[0]
    B = num_blocks
    if c % (B * n):
        raise ValueError(f"payload {c} not divisible by num_blocks*n={B * n}")
    s = c // (B * n)
    rest = x.shape[1:]
    j = topo.lane_rank()
    xb = x.reshape(B, n * s, *rest)
    out = torch.zeros((B, s, *rest), dtype=torch.float32, device=x.device)
    buf = None                                    # received last step
    sent = []                                     # last step's send
    for t in range(pipeline_steps(B, N)):
        b = t - (N - 1 - j)                       # block forwarded at step t
        held = 0 <= b < B
        # the next block's partial is received while this step's node
        # phase runs, and this step's send stays in flight through the
        # next one's
        nxt = out.new_empty((s, *rest)) if j < N - 1 and 0 <= b + 1 < B \
            else None
        works = _p2p(topo, recv=nxt, frm=j + 1)
        part = None
        if held:                                  # fold the node dimension
            mine = xb[b].to(torch.float32).contiguous()
            part = mine.new_empty((s, *rest))
            dist.reduce_scatter_tensor(part, mine, group=topo.node_group)
            if j < N - 1:
                part += buf
            if j == 0:
                out[b] = part
        sending = _p2p(topo, send=part if held and j > 0 else None,
                       to=j - 1)
        _wait(works + sent)
        sent, buf = sending, nxt
    _wait(sent)
    full = out.new_empty((B, n * s, *rest))
    for b in range(B):
        dist.all_gather_into_tensor(full[b], out[b], group=topo.node_group)
    full = full.reshape(c, *rest).to(x.dtype)
    if topo.lane_rank() != root_lane or topo.node_rank() != 0:
        full.zero_()
    return full


def _lane_ring_allreduce_(v, topo: LaneTopology) -> None:
    """Ring allreduce of ``v`` over the lane group, in place: partials
    circulate N-1 hops on the ring j → j+1 (mod N), each added on
    arrival.  At N=1 ``v`` is already the sum and nothing is sent."""
    N = topo.N()
    if N == 1:
        return
    j = topo.lane_rank()
    msg = v.clone()
    for _ in range(N - 1):
        new = torch.empty_like(msg)
        _wait(_p2p(topo, send=msg, to=(j + 1) % N, recv=new,
                   frm=(j - 1) % N))
        v += new
        msg = new


def pipelined_allreduce_(buf, topo: LaneTopology, *, num_blocks: int):
    """The pipelined full-lane ALLREDUCE of the contiguous ``buf``, in
    place: the §5 recipe applied to Listing 4.

    ``buf`` is split into ``num_blocks`` blocks that stream through three
    stages; at step t

      stage 1  RS(node)  of block t        — into its own stripe
      stage 2  ring-AR(lane) of block t-1  — that stripe, on the lane ring
      stage 3  AG(node)  of block t-2      — from its stripe

    Stages 1 and 3 are issued asynchronously on the node group before
    stage 2 runs on the lane group, and all three touch different blocks,
    so the node and lane levels work at the same time.  Every collective
    writes in place: the reduce-scatter into the process's stripe of the
    block it reads, the all-gather from that stripe.  Requires
    ``buf.shape[0] % (num_blocks * n) == 0``.
    """
    n = topo.n()
    c = buf.shape[0]
    B = num_blocks
    if B < 1:
        raise ValueError(f"num_blocks must be >= 1, got {B}")
    if c % (B * n):
        raise ValueError(f"payload {c} not divisible by num_blocks*n={B * n}")
    blk = c // B
    s = blk // n
    i = topo.node_rank()
    blocks = buf.view(B, blk, *buf.shape[1:])
    for t in range(allreduce_pipeline_steps(B)):
        works = []
        if t < B:
            works.append(dist.reduce_scatter_tensor(
                _stripe(blocks[t], i, s), blocks[t], group=topo.node_group,
                async_op=True))
        if 0 <= t - 2 < B:
            works.append(dist.all_gather_into_tensor(
                blocks[t - 2], _stripe(blocks[t - 2], i, s),
                group=topo.node_group, async_op=True))
        if 0 <= t - 1 < B:
            _lane_ring_allreduce_(_stripe(blocks[t - 1], i, s), topo)
        _wait(works)
    return buf


def _pipelined_allreduce_lane(x, topo: LaneTopology, *, num_blocks: int):
    """Pipelined full-lane allreduce of ``x`` (``repro``'s functional
    form): sums in f32 for floating dtypes (exact dtypes accumulate
    natively) and returns the full sum on every process."""
    acc = torch.float32 if x.is_floating_point() else x.dtype
    buf = x.to(acc).contiguous().clone()
    return pipelined_allreduce_(buf, topo, num_blocks=num_blocks).to(x.dtype)


def pipelined_allgather_lane(x, topo: LaneTopology, *, num_blocks: int):
    """Pipelined full-lane ALLGATHER — the §5 recipe applied to Listing 3.

    The input is this process's 1/p stripe of the result (the ZeRO-3
    parameter shard), split into ``num_blocks`` blocks; at step t the
    lane all-gather of block t and the node all-gather of block t-1 run
    together.  Output rows are ordered (block, node_rank, lane_rank, s),
    ``repro``'s zero3 shard layout.  Requires ``x.shape[0] % num_blocks
    == 0``.
    """
    n, N = topo.n(), topo.N()
    c = x.shape[0]
    B = num_blocks
    if B < 1:
        raise ValueError(f"num_blocks must be >= 1, got {B}")
    if c % B:
        raise ValueError(f"shard {c} not divisible by num_blocks={B}")
    s = c // B
    rest = x.shape[1:]
    i = topo.node_rank()
    xb = x.reshape(B, s, *rest)
    out = x.new_empty((B, n, N * s, *rest))
    for t in range(B + 1):
        works = []
        if t < B:                                 # stage 1: AG(lane)
            works.append(dist.all_gather_into_tensor(
                out[t, i], xb[t].contiguous(), group=topo.lane_group,
                async_op=True))
        if t >= 1:                                # stage 2: AG(node)
            works.append(dist.all_gather_into_tensor(
                out[t - 1].view(n * N * s, *rest), out[t - 1, i],
                group=topo.node_group, async_op=True))
        _wait(works)
    return out.reshape(B * n * N * s, *rest)


def pipelined_reduce_scatter_lane_(x, topo: LaneTopology, *, num_blocks: int):
    """The transpose of :func:`pipelined_allgather_lane`, in place: the
    ZeRO-3 gradient of a gathered layer back to its shard (what ``repro``
    gets from JAX's AD of the gather).

    ``x`` is the (B·n·N·s, ...) cotangent of a gathered row, rows ordered
    (block, node_rank, lane_rank, s).  Blocks run in the transposed order,
    last first; at step t the RS(node) of block B-1-t (into this
    process's node stripe of the block) and the RS(lane) of block B-t
    (that stripe into its lane rank's s rows) are issued together on
    their groups.  Returns this process's (B·s, ...) sums: a view of
    ``x`` when p = 1, else a copy.
    """
    n, N = topo.n(), topo.N()
    B = num_blocks
    if B < 1:
        raise ValueError(f"num_blocks must be >= 1, got {B}")
    c = x.shape[0]
    if c % (B * n * N):
        raise ValueError(f"payload {c} not divisible by num_blocks*p="
                         f"{B * n * N}")
    s = c // (B * n * N)
    rest = x.shape[1:]
    i, j = topo.node_rank(), topo.lane_rank()
    xb = x.view(B, n, N * s, *rest)
    for t in range(B + 1):
        works = []
        if t < B:                                 # stage 1: RS(node)
            b = B - 1 - t
            works.append(dist.reduce_scatter_tensor(
                xb[b, i], xb[b].view(n * N * s, *rest),
                group=topo.node_group, async_op=True))
        if t >= 1:                                # stage 2: RS(lane)
            stripe = xb[B - t, i]
            works.append(dist.reduce_scatter_tensor(
                stripe[j * s:(j + 1) * s], stripe, group=topo.lane_group,
                async_op=True))
        _wait(works)
    return x.view(B, n, N, s, *rest)[:, i, j].reshape(B * s, *rest)
