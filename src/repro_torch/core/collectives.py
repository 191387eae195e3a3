"""Full-lane collective mock-ups (paper §3, Listings 1-6) on
``torch.distributed`` process groups.

Counterpart of ``repro.core.collectives``.  Every function is one of the
paper's performance-guideline implementations: the payload is split
evenly over the *node*-level processes, the inter-node part runs as n
concurrent collectives over the *lane* groups (each carrying 1/n of the
payload — the "full-lane" property), and node-level collectives
split/reassemble.  Each takes this process's local tensor; the leading
dimension plays the role of the MPI element count ``c``.  Every process
of the topology must make the same call.

Where MPI uses a rooted collective, so does the port: ``broadcast``,
``reduce``, ``gather`` and ``scatter`` on the node or lane group, the
paper's own form.  The outputs follow ``repro``'s SPMD convention, so the
two packages agree bit for bit on integer-valued payloads: zeros off the
root for ``reduce_lane`` / ``gather_lane`` (and the native ``reduce`` /
``gather``), blocks in global-rank order after the Listing-5 permute and
the Listing-3 reorder.  ``scan`` has no torch.distributed primitive; it
is emulated as ``repro`` emulates it, by an all-gather and a rank-masked
sum.

The natives are the one-shot comparators over the whole communicator
(``topo.group``), the "native library" the paper measures against.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .lane import LaneTopology

__all__ = [
    "allreduce_lane", "reduce_scatter_lane", "allgather_lane", "bcast_lane",
    "alltoall_lane", "reduce_lane", "gather_lane", "scatter_lane",
    "scan_lane",
    "native_allreduce", "native_allgather", "native_reduce_scatter",
    "native_alltoall", "native_scan",
]

# torch >= 2.13 renames all_gather_into_tensor / reduce_scatter_tensor to
# *_single and warns on the old names; older torch has only the old names,
# so the port calls those and silences that one warning.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|reduce_scatter_tensor)`"
            r" is deprecated")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _divisible(lead: int, k: int, name: str) -> None:
    if lead % k:
        raise ValueError(f"leading dim {lead} not divisible by {name}={k}")


def _rs(x, group, size: int):
    """Reduce-scatter over ``group`` (``size`` ranks): leading dim / size."""
    _divisible(x.shape[0], size, "group size")
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _ag(x, group, size: int):
    """All-gather over ``group`` (``size`` ranks), rank-major on dim 0."""
    out = x.new_empty((x.shape[0] * size, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _a2a(x, group):
    """All-to-all over ``group``: dim-0 chunk r goes to group rank r."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _swap01(x, a: int, b: int, m: int):
    """Rows viewed as (a, b, m): return them as (b, a, m), contiguous."""
    rest = x.shape[1:]
    return x.reshape(a, b, m, *rest).transpose(0, 1).reshape(
        a * b * m, *rest)


def _masked_sum(stacked, keep):
    """Sum over dim 0 of the rows ``keep`` selects, in the input dtype."""
    keep = keep.reshape(-1, *([1] * (stacked.ndim - 1)))
    return torch.where(keep, stacked, torch.zeros((), dtype=stacked.dtype,
                                                  device=stacked.device)
                       ).sum(0, dtype=stacked.dtype)


# --------------------------------------------------------------------------
# Allreduce (paper Listing 4):  RS(node) ∘ AR(lane) ∘ AG(node)
# --------------------------------------------------------------------------

def allreduce_lane(x, topo: LaneTopology):
    """Full-lane allreduce.

    ReduceScatter on the node level leaves each process with c/n partial
    sums; the n concurrent lane-level allreduces each move only c/n over
    the inter-node fabric; AllGather on the node level reassembles.
    Leading dim must be divisible by n.
    """
    n = topo.n()
    _divisible(x.shape[0], n, "n")
    r = _rs(x, topo.node_group, n)
    dist.all_reduce(r, group=topo.lane_group)
    return _ag(r, topo.node_group, n)


def native_allreduce(x, topo: LaneTopology):
    """The 'native library' comparator: one allreduce over the whole
    communicator."""
    out = x.clone()
    dist.all_reduce(out, group=topo.group)
    return out


# --------------------------------------------------------------------------
# Reduce_scatter_block (paper Listing 5):  permute ∘ RS(node) ∘ RS(lane)
# --------------------------------------------------------------------------

def reduce_scatter_lane(x, topo: LaneTopology):
    """Full-lane reduce-scatter-block.

    Input: p·m leading rows = p blocks of m rows, block g destined for
    global rank g (= lane_rank·n + node_rank).  Output: this process's
    block of m rows, fully reduced.  The blocks are first permuted into
    lane order (the Listing-5 (N, n) → (n, N) transpose, a copy as in the
    paper).
    """
    n, N = topo.n(), topo.N()
    p = n * N
    _divisible(x.shape[0], p, "p")
    m = x.shape[0] // p
    r = _rs(_swap01(x, N, n, m), topo.node_group, n)   # stripe: (N*m, ...)
    return _rs(r, topo.lane_group, N)                  # own block: (m, ...)


def native_reduce_scatter(x, topo: LaneTopology):
    """One-shot comparator: reduce-scatter over the whole communicator,
    blocks in global-rank order."""
    _divisible(x.shape[0], topo.p(), "p")
    return _rs(x, topo.group, topo.p())


# --------------------------------------------------------------------------
# Allgather (paper Listing 3):  AG(lane) ∘ AG(node)  [+ rank-order fixup]
# --------------------------------------------------------------------------

def allgather_lane(x, topo: LaneTopology, *, reorder: bool = True):
    """Full-lane allgather.

    Each process first allgathers its own m-row block over its lane, then
    the node level replicates.  The natural output order is node-major
    [i][j]; ``reorder=True`` transposes to global-rank order [j][i].
    """
    m = x.shape[0]
    n, N = topo.n(), topo.N()
    y = _ag(x, topo.lane_group, N)                     # (N*m, ...)
    z = _ag(y, topo.node_group, n)                     # (n*N*m, ...) [i][j]
    return _swap01(z, n, N, m) if reorder else z


def native_allgather(x, topo: LaneTopology):
    """One-shot comparator in global-rank order."""
    return _ag(x, topo.group, topo.p())


# --------------------------------------------------------------------------
# Broadcast (paper Listing 1):  Scatter(node) ∘ Bcast(lane) ∘ AG(node)
# --------------------------------------------------------------------------

def bcast_lane(x, topo: LaneTopology, *, root_lane: int = 0,
               root_node: int = 0, root_replicated: bool = True):
    """Full-lane broadcast of the root process's buffer to every process.

    root = (root_lane, root_node) in (lane_rank, node_rank) coordinates.

    * Scatter(node): if ``root_replicated`` (the buffer is already the
      same on every process of the root node) the scatter is a local
      stripe slice.  Otherwise the root scatters the stripes over its
      node.
    * Bcast(lane): n concurrent lane broadcasts of c/n each.
    * AllGather(node) reassembles; stripes were cut in node-rank order so
      the result needs no reorder.
    """
    n = topo.n()
    _divisible(x.shape[0], n, "n")
    m = x.shape[0] // n
    i, on_root_lane = topo.node_rank(), topo.lane_rank() == root_lane
    if root_replicated:
        stripe = x[i * m:(i + 1) * m].clone()
    else:
        stripe = x.new_empty((m, *x.shape[1:]))
        if on_root_lane:
            parts = list(x.contiguous().split(m)) if i == root_node else None
            dist.scatter(stripe, parts, src=topo.node_peer(root_node),
                         group=topo.node_group)
    dist.broadcast(stripe, src=topo.lane_peer(root_lane),
                   group=topo.lane_group)
    return _ag(stripe, topo.node_group, n)


# --------------------------------------------------------------------------
# Alltoall (paper Listing 6):  A2A(lane) ∘ A2A(node)
# --------------------------------------------------------------------------

def alltoall_lane(x, topo: LaneTopology):
    """Full-lane all-to-all.

    Input: p blocks of m rows in global-destination-rank order.  Output: p
    blocks in global-source-rank order.  The lane exchange moves the
    (N-1)·n·m rows bound for other nodes, n lane all-to-alls concurrently;
    the node exchange moves (n-1)·N·m rows.
    """
    n, N = topo.n(), topo.N()
    p = n * N
    _divisible(x.shape[0], p, "p")
    m = x.shape[0] // p
    y = _a2a(x, topo.lane_group)                  # (src_j, dest_i, m)
    z = _a2a(_swap01(y, N, n, m), topo.node_group)  # (src_i, src_j, m)
    return _swap01(z, n, N, m)                    # (src_j, src_i, m)


def native_alltoall(x, topo: LaneTopology):
    """One-shot comparator: one all-to-all over the whole communicator —
    the 'direct algorithm' of §3.5."""
    _divisible(x.shape[0], topo.p(), "p")
    return _a2a(x, topo.group)


# --------------------------------------------------------------------------
# Reduce (paper §3.4):  RS(node) ∘ Reduce(lane) ∘ Gather(node→root)
# --------------------------------------------------------------------------

def reduce_lane(x, topo: LaneTopology, *, root_lane: int = 0,
                root_node: int = 0):
    """Full-lane reduce; the summed buffer is valid on the root process,
    zeros elsewhere."""
    n = topo.n()
    _divisible(x.shape[0], n, "n")
    m = x.shape[0] // n
    i, j = topo.node_rank(), topo.lane_rank()
    r = _rs(x, topo.node_group, n)
    dist.reduce(r, dst=topo.lane_peer(root_lane), group=topo.lane_group)
    out = torch.zeros_like(x)
    if j == root_lane:
        parts = list(out.split(m)) if i == root_node else None
        dist.gather(r, parts, dst=topo.node_peer(root_node),
                    group=topo.node_group)
    return out


# --------------------------------------------------------------------------
# Scan (paper abstract list / §3):  Scan(node) ∘ Exscan(lane, striped) ∘
#                                   AG(node)
# --------------------------------------------------------------------------

def scan_lane(x, topo: LaneTopology):
    """Full-lane inclusive scan (MPI_Scan): out on global rank g is
    Σ_{g'≤g} x_{g'}, elementwise.

    (1) inclusive Scan over the node group; (2) the node TOTALS need an
    exclusive scan over the lane group, striped 1/n per on-node process,
    so the n concurrent lane exscans each move only c/n inter-node;
    (3) AllGather(node) reassembles the exscanned totals, which are then
    added to the local node scan.  Both scans are emulated as all-gather
    + rank-masked local sums, as in ``repro``.  Leading dim must be
    divisible by n.
    """
    n, N = topo.n(), topo.N()
    c = x.shape[0]
    _divisible(c, n, "n")
    m = c // n
    i, j = topo.node_rank(), topo.lane_rank()
    rest = x.shape[1:]

    gn = _ag(x, topo.node_group, n).reshape(n, c, *rest)
    t = _masked_sum(gn, torch.arange(n, device=x.device) <= i)
    tot = gn.sum(0, dtype=x.dtype)
    gl = _ag(tot[i * m:(i + 1) * m], topo.lane_group, N).reshape(N, m, *rest)
    e = _masked_sum(gl, torch.arange(N, device=x.device) < j)
    return t + _ag(e, topo.node_group, n)


def native_scan(x, topo: LaneTopology):
    """One-shot comparator: gather the whole communicator, prefix-sum by
    global rank locally."""
    p = topo.p()
    z = _ag(x, topo.group, p).reshape(p, *x.shape)
    return _masked_sum(z, torch.arange(p, device=x.device)
                       <= topo.global_rank())


# --------------------------------------------------------------------------
# Gather / Scatter (paper §3.2, Listing 2)
# --------------------------------------------------------------------------

def gather_lane(x, topo: LaneTopology, *, root_lane: int = 0,
                root_node: int = 0):
    """Full-lane gather: the root process ends with all p blocks in global
    rank order, the others with zeros.  Gather(lane) to the root lane,
    then Gather(node) to the root; the [i][j] → [j][i] transpose places
    the blocks."""
    m = x.shape[0]
    n, N = topo.n(), topo.N()
    i, j = topo.node_rank(), topo.lane_rank()
    rest = x.shape[1:]
    g1 = x.new_zeros((N * m, *rest))
    dist.gather(x.contiguous(), list(g1.split(m)) if j == root_lane else None,
                dst=topo.lane_peer(root_lane), group=topo.lane_group)
    out = x.new_zeros((n * N * m, *rest))
    if j == root_lane:
        g2 = x.new_zeros((n * N * m, *rest)) if i == root_node else None
        dist.gather(g1, None if g2 is None else list(g2.split(N * m)),
                    dst=topo.node_peer(root_node), group=topo.node_group)
        if g2 is not None:
            out = _swap01(g2, n, N, m)
    return out


def scatter_lane(x, topo: LaneTopology, *, root_lane: int = 0,
                 root_node: int = 0, root_replicated: bool = True):
    """Full-lane scatter: every process receives its global-rank block of
    the root's p·m buffer.  Scatter(node@root node) ∘ Scatter(lane).

    With ``root_replicated`` the node-level scatter is a local stripe
    pick; otherwise the root scatters the stripes over its node.
    """
    n, N = topo.n(), topo.N()
    p = n * N
    _divisible(x.shape[0], p, "p")
    m = x.shape[0] // p
    rest = x.shape[1:]
    i, j = topo.node_rank(), topo.lane_rank()
    if j == root_lane:
        xb = x.reshape(N, n, m, *rest)
        if root_replicated:
            stripe = xb[:, i].contiguous()                 # (N, m, ...)
        else:
            stripe = x.new_empty((N, m, *rest))
            parts = [xb[:, k].contiguous() for k in range(n)] \
                if i == root_node else None
            dist.scatter(stripe, parts, src=topo.node_peer(root_node),
                         group=topo.node_group)
        parts = list(stripe.unbind(0))
    else:
        parts = None
    out = x.new_empty((m, *rest))
    dist.scatter(out, parts, src=topo.lane_peer(root_lane),
                 group=topo.lane_group)
    return out
