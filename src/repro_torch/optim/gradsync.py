"""Gradient synchronization machinery — where the paper meets training.

Counterpart of ``repro.optim.gradsync``: the flatten/pad of a gradient
tree, the int8 compress/pack of the lane hop, the bucket count, the
wave-skewed bucket schedule and the node and lane stages.  The strategy
dispatch (``native`` / ``lane`` / ``lane_pipelined`` / ``lane_int8``)
lives in the registry, :mod:`repro_torch.comm.impls`.

Every bucketed strategy flattens the gradient tree into one f32 vector,
pads it and splits it into K equal buckets; each bucket runs
ReduceScatter(node) → Allreduce(lane) → AllGather(node).  Unlike
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
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.core.costmodel import optimal_num_buckets
from repro_torch.core.lane import LaneTopology

__all__ = ["compress_int8", "decompress_int8", "pack_int8_payload",
           "unpack_int8_payload", "resolve_num_buckets", "bucket_schedule"]


def _flatten_bucket(tree, pad_to: int):
    """(flat, spec): the leaves of ``tree`` in ``_tree`` order, cast to
    f32 into one new buffer zero-padded to a multiple of ``pad_to``."""
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
    (q (C, 1024) int8, scales (C, 1) f32, len(x))."""
    n = x.shape[0]
    pad = (-n) % _INT8_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xr = x.reshape(-1, _INT8_CHUNK)
    scale = xr.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
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
    flight together.  Returns the bucket views.
    """
    K = num_buckets
    if flat.shape[0] % K:
        raise ValueError(
            f"flat dim {flat.shape[0]} not divisible by num_buckets={K}")
    vals = list(flat.view(K, -1).unbind(0))
    S = len(stages)
    done = [0] * K                     # stages applied so far, per bucket
    for wave in range(K + S - 1):
        pending = []
        for b in range(min(wave, K - 1), max(wave - S, -1), -1):
            s = wave - b
            if 0 <= s < S and done[b] == s:
                pending.append(stages[s](vals[b]))
                done[b] += 1
        for finish in pending:
            if finish is not None:
                finish()
    if not all(d == S for d in done):
        raise RuntimeError(
            f"bucket schedule incomplete: stage counts {done}, "
            f"expected {S} each")
    return vals


def _stripe(v, topo: LaneTopology):
    s = v.shape[0] // topo.n()
    i = topo.node_rank()
    return v[i * s:(i + 1) * s]


def _rs_node(topo: LaneTopology):
    """ReduceScatter(node) of a bucket into this process's stripe of it."""
    def stage(v):
        return dist.reduce_scatter_tensor(
            _stripe(v, topo), v, group=topo.node_group, async_op=True).wait
    return stage


def _ag_node(topo: LaneTopology):
    """AllGather(node) of the stripes back over the whole bucket."""
    def stage(v):
        return dist.all_gather_into_tensor(
            v, _stripe(v, topo), group=topo.node_group, async_op=True).wait
    return stage


def _ar_lane(topo: LaneTopology):
    """Allreduce(lane) of this process's stripe."""
    def stage(v):
        return dist.all_reduce(_stripe(v, topo), group=topo.lane_group,
                               async_op=True).wait
    return stage


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
    return stage

