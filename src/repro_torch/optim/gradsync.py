"""Gradient synchronization machinery — where the paper meets training.

Counterpart of ``repro.optim.gradsync``: the flatten/pad of a gradient
tree, the int8 compress/pack of the lane hop, the bucket count, the
wave-skewed bucket schedule and the node and lane stages.  The strategy
dispatch (``native`` / ``lane`` / ``lane_pipelined`` / ``lane_int8``)
lives in the registry, :mod:`repro_torch.comm.impls`.

Every bucketed strategy flattens the gradient tree into one f32 vector
in ``repro``'s flat order (``_tree.leaves``: the same elements in
the same places, so the buckets, the int8 chunks and the ZeRO shards
hold what ``repro``'s hold), pads it and splits it into K equal
buckets; each bucket runs ReduceScatter(node) → Allreduce(lane) →
AllGather(node).  Unlike
``repro``, which is functional, the port works in place, because a copy
of llama3.2-3b's gradients is 12.8 GB:

  * ``_flatten_bucket`` copies the leaves into ONE preallocated f32
    buffer (the cast included);
  * every stage writes into a view of that buffer: the reduce-scatter
    into the process's stripe of the bucket it reads, the lane allreduce
    on that stripe, the all-gather from the stripe into the bucket (NCCL
    takes both in place when the stripe is the rank's slice);
  * ``_unflatten_bucket`` copies the result back into the gradient
    leaves, casting to their dtype.

So a sync holds one f32 copy of the gradients beyond the gradients
themselves.

Each stage carries a name (``_stage``), and ``bucket_schedule`` runs a
stage's launch and its finish under the ``repro_torch.obs`` span
``grad_sync/<name>``: ``rs_node``, ``ar_lane``, ``ag_node``,
``ar_lane_int8``, ``rs_lane`` and ``ar_lane_quorum``
(``runtime.straggler``), so each hop's NCCL kernels are attributed to
the hop, also while two waves overlap.  The strategies in
``comm/impls.py`` run the flatten under ``grad_sync/flatten`` and the
mean's divide and the unflatten under ``grad_sync/unflatten``.

The ZeRO layouts are ``repro``'s: ``lane_zero1`` keeps the bucket-major
(K, n, s) node stripes (``zero1_param_shard`` / ``zero1_unshard``),
``lane_zero3`` the (B, n·N, s) stripes indexed ``node_rank·N +
lane_rank`` (``zero3_param_shard`` / ``zero3_unshard``), and
``decay_mask_flat`` marks the elements AdamW decays.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import _tree, obs
from repro_torch.core.costmodel import optimal_num_buckets
from repro_torch.core.lane import LaneTopology

__all__ = ["compress_int8", "decompress_int8", "pack_int8_payload",
           "unpack_int8_payload", "resolve_num_buckets", "bucket_schedule",
           "zero1_param_shard", "zero1_unshard", "zero3_param_shard",
           "zero3_unshard", "decay_mask_flat"]


def _flatten_bucket(tree, pad_to: int):
    """(flat, spec): the leaves of ``tree`` in ``repro``'s flat order, cast
    to f32 into one new buffer zero-padded to a multiple of ``pad_to``."""
    leaves = _tree.leaves(tree)
    n = sum(l.numel() for l in leaves)
    flat = torch.empty(n + (-n) % pad_to, dtype=torch.float32,
                       device=leaves[0].device)
    ofs = 0
    for l in leaves:
        flat[ofs:ofs + l.numel()].copy_(l.reshape(-1))
        ofs += l.numel()
    flat[n:].zero_()
    return flat, (tree, leaves, n)


def _unflatten_bucket(flat, spec):
    """Write ``flat``'s first n elements back into the leaves of the tree
    ``spec`` was made from, cast to each leaf's dtype; returns that
    tree."""
    tree, leaves, n = spec
    ofs = 0
    for l in leaves:
        l.copy_(flat[ofs:ofs + l.numel()].view(l.shape))
        ofs += l.numel()
    return tree


_INT8_CHUNK = 1024


def compress_int8(x):
    """Chunked symmetric int8 quantization of the 1-D f32 ``x``; returns
    (q (C, 1024) int8, scales (C, 1) f32, len(x)).  The scale divides by
    127 as a tensor on ``x``'s device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, one ulp off the CPU's (and
    ``repro``'s) quotient in some chunks, which moves their bytes."""
    n = x.shape[0]
    pad = (-n) % _INT8_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xr = x.reshape(-1, _INT8_CHUNK)
    scale = xr.abs().amax(dim=1, keepdim=True) \
        / torch.full((), 127.0, device=x.device) + 1e-12
    q = torch.clamp(torch.round(xr / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), n


def decompress_int8(q, scale, n):
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def pack_int8_payload(q, scale):
    """(C, chunk) int8 values + (C, 1) f32 scales -> ONE 1-D int8 wire
    buffer ``[q-bytes | scale-bytes]``: the scales' bytes reinterpreted
    (``view``), never converted, so one all-gather carries both."""
    sb = scale.to(torch.float32).reshape(-1).contiguous().view(torch.int8)
    return torch.cat([q.reshape(-1), sb])


def unpack_int8_payload(buf, num_chunks: int):
    """Inverse of pack_int8_payload: -> ((C, chunk) int8, (C, 1) f32)."""
    m = num_chunks * _INT8_CHUNK
    q = buf[:m].reshape(num_chunks, _INT8_CHUNK)
    scale = buf[m:m + 4 * num_chunks].contiguous().view(torch.float32)
    return q, scale.reshape(num_chunks, 1)


# ---------------------------------------------------------------------------
# bucket schedule (shared by every lane strategy)
# ---------------------------------------------------------------------------

def resolve_num_buckets(total_elems: int, n_node: int,
                        override: int = 0, *, elem_bytes: int = 4) -> int:
    """The K every bucketed strategy uses for ``total_elems`` gradients.

    override > 0 wins; otherwise the cost model picks K from the lane
    latency/bandwidth crossover on the per-lane payload (c/n bytes, the
    full-lane stripe), with the active constants (``get_hw``).
    K is capped so each bucket keeps at least one row per process after
    the node reduce-scatter.
    """
    if override > 0:
        k = override
    else:
        k = optimal_num_buckets(total_elems * elem_bytes / max(n_node, 1))
    return max(1, min(k, max(1, total_elems // max(n_node, 1))))


def bucket_schedule(flat, num_buckets: int,
                    stages: Sequence[Callable[[torch.Tensor],
                                              Optional[Callable]]]):
    """Run ``flat`` through per-bucket ``stages`` in stage-skewed order.

    Splits ``flat`` (leading dim divisible by num_buckets) into equal
    contiguous buckets and applies every stage to every bucket, wave by
    wave: bucket b's stage s+1 runs in the wave of bucket b+1's stage s,
    the emission order of ``repro``'s schedule.  A stage takes its
    bucket's view, works on it in place, and may return a ``finish``
    callable: it issues its collective asynchronously and ``finish``
    waits for it.  Each wave's finishes run at the end of the wave, so
    the stages of one wave (different buckets, different groups) are in
    flight together.  A stage named by ``_stage`` runs, launch and
    finish, under the span ``grad_sync/<name>``; an unnamed one under
    none.  Returns the bucket views.
    """
    K = num_buckets
    if flat.shape[0] % K:
        raise ValueError(
            f"flat dim {flat.shape[0]} not divisible by num_buckets={K}")
    vals = list(flat.view(K, -1).unbind(0))
    S = len(stages)
    spans = [getattr(st, "span", None) for st in stages]
    done = [0] * K                     # stages applied so far, per bucket
    for wave in range(K + S - 1):
        pending = []
        for b in range(min(wave, K - 1), max(wave - S, -1), -1):
            s = wave - b
            if 0 <= s < S and done[b] == s:
                with obs.span(spans[s]):
                    pending.append((spans[s], stages[s](vals[b])))
                done[b] += 1
        for name, finish in pending:
            if finish is not None:
                with obs.span(name):
                    finish()
    if not all(d == S for d in done):
        raise RuntimeError(
            f"bucket schedule incomplete: stage counts {done}, "
            f"expected {S} each")
    return vals


def _stage(name: str, stage):
    """``stage``, which ``bucket_schedule`` runs under ``grad_sync/<name>``."""
    stage.span = f"grad_sync/{name}"
    return stage


def _stripe(v, topo: LaneTopology):
    s = v.shape[0] // topo.n()
    i = topo.node_rank()
    return v[i * s:(i + 1) * s]


def _rs_node(topo: LaneTopology):
    """ReduceScatter(node) of a bucket into this process's stripe of it."""
    def stage(v):
        return dist.reduce_scatter_tensor(
            _stripe(v, topo), v, group=topo.node_group, async_op=True).wait
    return _stage("rs_node", stage)


def _ag_node(topo: LaneTopology):
    """AllGather(node) of the stripes back over the whole bucket."""
    def stage(v):
        return dist.all_gather_into_tensor(
            v, _stripe(v, topo), group=topo.node_group, async_op=True).wait
    return _stage("ag_node", stage)


def _ar_lane(topo: LaneTopology):
    """Allreduce(lane) of this process's stripe."""
    def stage(v):
        return dist.all_reduce(_stripe(v, topo), group=topo.lane_group,
                               async_op=True).wait
    return _stage("ar_lane", stage)


def _ar_lane_int8(topo: LaneTopology):
    """Compressed lane allreduce: ONE all-gather per bucket of the packed
    int8 payload (values and scales together), then every lane's stripe
    dequantized and summed, in lane order, into the stripe."""
    N = topo.N()

    def stage(v):
        stripe = _stripe(v, topo)
        q, scale, n = compress_int8(stripe)
        num_chunks = q.shape[0]
        buf = pack_int8_payload(q, scale)
        flat_g = buf.new_empty(N * buf.shape[0])
        work = dist.all_gather_into_tensor(flat_g, buf, group=topo.lane_group,
                                      async_op=True)
        g = flat_g.view(N, buf.shape[0])

        def finish():
            work.wait()
            out = torch.zeros(n, dtype=torch.float32, device=v.device)
            for i in range(N):
                qi, si = unpack_int8_payload(g[i], num_chunks)
                out = out + decompress_int8(qi, si, n)
            stripe.copy_(out)
        return finish
    return _stage("ar_lane_int8", stage)



def _rs_lane(topo: LaneTopology):
    """ReduceScatter(lane) of this process's node stripe of a bucket into
    its lane rank's chunk of that stripe (the ``lane_zero3`` stage)."""
    def stage(v):
        stripe = _stripe(v, topo)
        s = stripe.shape[0] // topo.N()
        j = topo.lane_rank()
        return dist.reduce_scatter_tensor(
            stripe[j * s:(j + 1) * s], stripe, group=topo.lane_group,
            async_op=True).wait
    return _stage("rs_lane", stage)


# ---------------------------------------------------------------------------
# ZeRO-1 shard layout (bucket-major, mirrors the bucketed reduce-scatter)
# ---------------------------------------------------------------------------
#
# With K buckets, process i's lane_zero1 shard is its node stripe of every
# bucket, [b0·stripe_i, b1·stripe_i, ...]: the flat vector viewed as
# (K, n, s) taken at node_rank on the middle axis.  Reassembly needs
# repro's (n, K) → (K, n) swap (the paper's Listing-5 reorder).

def zero1_param_shard(flat, topo: LaneTopology, num_buckets: int):
    """This process's (K·s,) shard of the padded flat vector, the layout
    ``grad_sync(..., "lane_zero1", num_buckets=K)`` returns: a view of
    ``flat`` when n = 1, else a copy."""
    n, K = topo.n(), num_buckets
    s = flat.shape[0] // (K * n)
    return flat.view(K, n, s)[:, topo.node_rank()].reshape(K * s)


def zero1_unshard(shard, topo: LaneTopology, num_buckets: int, out=None):
    """All-gather every process's (K·s,) shard over the node group into
    the flat (K·n·s,) order, in ``out`` (a new buffer if None).

    ``repro`` gathers whole shards, rank-major (n, K, s), and swaps them
    to (K, n, s): a second flat copy.  Here each bucket's gather lands at
    its own place, so the swap is the addressing of K all-gathers (one
    per bucket, in flight together): bucket b's n stripes fill row b of
    ``out`` viewed (K, n·s).  Where ``shard`` is ``out``'s own stripe of
    each bucket (``zero1_param_shard`` of ``out`` at n = 1) the gathers
    run in place."""
    n, K = topo.n(), num_buckets
    s = shard.shape[0] // K
    if out is None:
        out = shard.new_empty(K * n * s)
    rows, parts = out.view(K, n * s), shard.view(K, s)
    works = [dist.all_gather_into_tensor(rows[b], parts[b],
                                         group=topo.node_group,
                                         async_op=True) for b in range(K)]
    for w in works:
        w.wait()
    return out


# ---------------------------------------------------------------------------
# ZeRO-3 shard layout (bucket-major over node_rank × lane_rank)
# ---------------------------------------------------------------------------
#
# ZeRO-3 shards over the whole p = n·N communicator: with B blocks,
# process (node_rank i, lane_rank j) holds the flat vector viewed as
# (B, n·N, s) at [:, i·N + j, :].  That is the order
# core.pipeline.pipelined_allgather_lane reassembles blocks in, so the
# per-layer gather needs no permute; only the monolithic unshard pays one.

def zero3_param_shard(flat, topo: LaneTopology, num_blocks: int):
    """This process's 1/p stripe of the padded flat vector: the layout
    ``grad_sync(..., "lane_zero3", num_buckets=B)`` returns and
    ``pipelined_allgather_lane`` gathers (a view when p = 1)."""
    n, N, B = topo.n(), topo.N(), num_blocks
    rest = flat.shape[1:]
    s = flat.shape[0] // (B * n * N)
    idx = topo.node_rank() * N + topo.lane_rank()
    return flat.view(B, n * N, s, *rest)[:, idx].reshape(B * s, *rest)


def zero3_unshard(shard, topo: LaneTopology, num_blocks: int):
    """Monolithic reassembly of the (B·s,) stripes to the flat (B·n·N·s,)
    vector: AG(lane) then AG(node) of the WHOLE shard, which lands the
    rows in (i, j, b, s) order, then repro's (n·N, B) → (B, n·N)
    permute.  The blocking comparator of the pipelined per-block gather
    (``--fsdp-prefetch -1``)."""
    n, N, B = topo.n(), topo.N(), num_blocks
    rest = shard.shape[1:]
    c = shard.shape[0]
    lane = shard.new_empty((N * c, *rest))
    dist.all_gather_into_tensor(lane, shard.contiguous(),
                                group=topo.lane_group)
    g = shard.new_empty((n * N * c, *rest))
    dist.all_gather_into_tensor(g, lane, group=topo.node_group)
    s = c // B
    return g.view(n * N, B, s, *rest).transpose(0, 1).reshape(
        B * n * N * s, *rest)


# ---------------------------------------------------------------------------
# optimizer-layout helper (shared by the sharded-AdamW call sites)
# ---------------------------------------------------------------------------

def decay_mask_flat(tree, pad_to: int, *, dtype=torch.float32):
    """0/1 mask over the ``_flatten_bucket`` layout of ``tree``: 1 where
    the element's leaf has rank >= 2 in ``repro``'s layout (a leaf of a
    layer stack counts its L axis), exactly the leaves AdamW decays;
    padding 0.  ``dtype``: f32 as ``repro``'s, or bool, a quarter of the
    memory, for the flat AdamW (``launch/steps.py``)."""
    flat = _tree.flatten(tree)
    n = sum(leaf.numel() for _, leaf in flat)
    mask = torch.ones(n + (-n) % pad_to, dtype=dtype,
                      device=flat[0][1].device)
    ofs = 0
    for path, leaf in flat:
        if leaf.ndim + _tree.is_stacked(path) < 2:
            mask[ofs:ofs + leaf.numel()] = 0
        ofs += leaf.numel()
    mask[n:] = 0
    return mask
