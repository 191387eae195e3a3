"""The collective recorder behind lanelint: the communication footprint
of what a cell or a step issues on ``torch.distributed``.

Counterpart of ``repro.analysis.footprint``.  ``repro`` lowers a cell to
compiled HLO and parses the collectives out of it; the port has no HLO,
so :func:`record_collectives` watches the ``torch.distributed`` calls a
cell or a step makes on a real world and builds the same
:class:`CommFootprint` from them.  Every op is classified by
*communication level* under the lane-major rank convention
(``global_rank = lane_rank·n + node_rank``, ``core/lane.py``):

  ``"node"``    every member of the group lives in one node;
  ``"lane"``    the group holds at most one member per node;
  ``"global"``  the group covers every process (a native collective);
  ``"mixed"``   anything else: a group that straddles nodes without
                covering them, the shape the R1 level-disjointness rule
                forbids.

Wire bytes per op (g = group size), ``repro``'s conventions for the
kinds both packages issue:

  all-reduce       2·(g−1)/g · result_bytes
  all-gather         (g−1)/g · result_bytes   (result = the gathered buf)
  reduce-scatter     (g−1)   · result_bytes   (result = one shard)
  all-to-all         (g−1)/g · result_bytes
  send                         result_bytes   (one hop, the whole buffer;
                                               ``repro``'s permute)
  recv                       0                (its bytes are the send's)

and for the rooted kinds, which ``repro`` emulates with a masked psum
and the port calls as such, what the busiest member of a
bandwidth-optimal implementation moves, charged to every member:

  broadcast, reduce            result_bytes   (the buffer: a pipelined
                                               chain passes it once
                                               through the root)
  gather, scatter    (g−1)   · result_bytes   (result = one member's
                                               block: the g−1 blocks that
                                               reach or leave the root)

So on every op each member is charged the op's bottleneck volume, and a
footprint's level totals are what its process moves at the ring rates.
Object broadcasts and barriers are recorded with 0 payload bytes.

Each recorded op carries its issue index and, for an async op, the index
at which its work handle's ``wait()`` ran (a synchronous op completes at
its issue index); :func:`overlap` reads the in-flight windows off them,
the counterpart of ``repro``'s ``collective_concurrency`` plus
``scan_carried_concurrency``.

``repro``'s HLO-only parts have no counterpart here: ``parse_hlo``,
``analyze``, the dot/conv FLOP counting, while-loop trip counts and
``collective_compute_concurrency``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Optional

import torch.distributed as dist

__all__ = ["CollOp", "CommFootprint", "classify_group", "record_collectives",
           "Recording", "overlap", "RAW_COLLECTIVES"]

#: the ``torch.distributed`` communication functions the recorder wraps
#: (and lanelint's A1 keeps inside the communication layers)
RAW_COLLECTIVES = (
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast", "reduce", "gather", "scatter",
    "batch_isend_irecv", "isend", "irecv", "send", "recv",
    "broadcast_object_list", "barrier",
)

#: wrapped function -> (footprint kind, its tensor argument)
_KIND = {
    "all_reduce": ("all-reduce", "tensor"),
    "all_gather_into_tensor": ("all-gather", "input_tensor"),
    "reduce_scatter_tensor": ("reduce-scatter", "input"),
    "all_to_all_single": ("all-to-all", "input"),
    "broadcast": ("broadcast", "tensor"),
    "reduce": ("reduce", "tensor"),
    "gather": ("gather", "tensor"),
    "scatter": ("scatter", "tensor"),
    "isend": ("send", "tensor"), "send": ("send", "tensor"),
    "irecv": ("recv", "tensor"), "recv": ("recv", "tensor"),
    "broadcast_object_list": ("broadcast-object", None),
    "barrier": ("barrier", None),
}

#: where the result that the wire convention is written against lies, if
#: not in the tensor argument
_RESULT_ARG = {"all-gather": "output_tensor", "reduce-scatter": "output",
               "all-to-all": "output"}


def _footprint_wire(kind: str, g: int, result_bytes: float) -> float:
    """Wire bytes of one op per member (module docstring)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * result_bytes
    if kind in ("reduce-scatter", "gather", "scatter"):
        return float(g - 1) * result_bytes
    if kind in ("send", "broadcast", "reduce"):
        return float(result_bytes)
    return 0.0                         # recv, object broadcasts, barriers


def classify_group(ids, *, n: int, num_devices: Optional[int] = None) -> str:
    """Communication level of one group under the lane-major convention
    (the node of global rank g is ``g // n``).

    "node" = one node; "lane" = at most one member per node; "global" =
    every process; "mixed" = straddles nodes without covering them, the
    R1-forbidden shape.  Single-member groups are "node" (no wire).
    """
    ids = tuple(ids)
    if not ids:
        return "global"
    if len(ids) <= 1:
        return "node"
    pods = {d // n for d in ids}
    if len(pods) == 1:
        return "node"
    if num_devices is not None and len(ids) == num_devices:
        return "global"
    if len(pods) == len(ids):
        return "lane"
    return "mixed"


@dataclasses.dataclass(frozen=True)
class CollOp:
    """One issued ``torch.distributed`` call.

    ``ranks``: the global ranks of its group (for a send or a receive,
    this process and its peer); ``payload_bytes``: the bytes of the tensor
    this process hands the call (numel × element size; for all-gather,
    reduce-scatter and all-to-all the input, for scatter the block it
    takes); ``result_bytes``: the size the wire convention is written
    against; ``wire_bytes``: per this member; ``issued`` / ``completed``:
    the recorder's indices (``completed`` None: never waited for);
    ``device``: the tensor's device type (None for objects and barriers).
    Every execution is its own record.
    """
    kind: str
    level: str
    ranks: tuple
    payload_bytes: float
    result_bytes: float
    wire_bytes: float
    async_op: bool
    issued: int
    completed: Optional[int]
    device: Optional[str]

    @property
    def group_size(self) -> int:
        return len(self.ranks)


class CommFootprint:
    """The collective ops one process issued, with per-level totals."""

    LEVELS = ("node", "lane", "global", "mixed")

    def __init__(self, ops, *, n: int, num_devices: Optional[int] = None):
        self.ops: tuple = tuple(ops)
        self.n = int(n)
        self.num_devices = num_devices

    def __len__(self) -> int:
        return len(self.ops)

    def wire(self, level: Optional[str] = None) -> float:
        """Total wire bytes, optionally restricted to a level."""
        return sum(o.wire_bytes for o in self.ops
                   if level is None or o.level == level)

    def by_level(self) -> dict:
        return {lv: self.wire(lv) for lv in self.LEVELS}

    def kind_counts(self, level: Optional[str] = None) -> dict:
        out: dict = {}
        for o in self.ops:
            if level is None or o.level == level:
                out[o.kind] = out.get(o.kind, 0) + 1
        return out

    def mixed(self) -> tuple:
        """The R1-violating ops (straddle nodes without covering all)."""
        return tuple(o for o in self.ops if o.level == "mixed")

    def levels(self) -> tuple:
        return tuple(lv for lv in self.LEVELS if any(
            o.level == lv for o in self.ops))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Raw:
    """A :class:`CollOp` before its level and wire, which depend on the
    node size the footprint is read under; ``completed`` is set by the
    handle's ``wait()``."""
    kind: str
    ranks: tuple
    payload_bytes: float
    result_bytes: float
    async_op: bool
    issued: int
    completed: Optional[int]
    device: Optional[str]


class Recording:
    """What :func:`record_collectives` saw, in issue order."""

    def __init__(self):
        self._raw: list = []
        self._tick = 0

    def _next(self) -> int:
        self._tick += 1
        return self._tick

    def footprint(self, *, n: int,
                  num_devices: Optional[int] = None) -> CommFootprint:
        """The :class:`CommFootprint` of the recorded ops, classified
        under node size ``n`` (``num_devices``: p, to tell "global")."""
        ops = [CollOp(level=classify_group(sorted(r.ranks), n=n,
                                           num_devices=num_devices),
                      wire_bytes=_footprint_wire(r.kind, len(r.ranks),
                                                 r.result_bytes),
                      **dataclasses.asdict(r))
               for r in self._raw]
        return CommFootprint(ops, n=n, num_devices=num_devices)


class _Work:
    """A work handle whose ``wait()`` marks its ops complete."""

    def __init__(self, rec: Recording, work, raws):
        self._rec, self._work, self._raws = rec, work, raws

    def wait(self, *args, **kw):
        out = self._work.wait(*args, **kw)
        if self._raws and self._raws[0].completed is None:
            t = self._rec._next()
            for r in self._raws:
                r.completed = t
        return out

    def __getattr__(self, name):
        return getattr(self._work, name)


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if t is not None else 0.0


def _ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _peer(group, peer, group_peer) -> int:
    if peer is None:
        peer = dist.get_global_rank(group, group_peer) \
            if group is not None else group_peer
    return int(peer)


_ACTIVE: list = []


def _wrap(name: str, orig, rec: Recording):
    kind, tensor_arg = _KIND[name]
    sig = inspect.signature(orig)

    def wrapper(*args, **kw):
        a = sig.bind(*args, **kw).arguments
        group = a.get("group")
        if kind in ("send", "recv"):
            key = "dst" if kind == "send" else "src"
            ranks = (dist.get_rank(),
                     _peer(group, a.get(key), a.get(f"group_{key}")))
        else:
            ranks = _ranks(group)
        tensor = a.get(tensor_arg) if tensor_arg else None
        result = a.get(_RESULT_ARG.get(kind), tensor)
        async_op = name in ("isend", "irecv") or bool(a.get("async_op"))
        t = rec._next()
        raw = _Raw(kind, ranks, _nbytes(tensor), _nbytes(result), async_op,
                   t, None if async_op else t,
                   tensor.device.type if tensor is not None else None)
        rec._raw.append(raw)
        work = orig(*args, **kw)
        return _Work(rec, work, [raw]) if work is not None else work
    return wrapper


def _wrap_batch(orig, originals, rec: Recording):
    isend = originals["isend"]

    def batch_isend_irecv(p2p_op_list):
        t = rec._next()
        me = dist.get_rank()
        raws = []
        for op in p2p_op_list:
            kind = "send" if op.op is isend else "recv"
            raws.append(_Raw(kind, (me, int(op.peer)), _nbytes(op.tensor),
                             _nbytes(op.tensor), True, t, None,
                             op.tensor.device.type))
        rec._raw.extend(raws)
        works = orig(p2p_op_list)
        if len(works) == len(raws):
            return [_Work(rec, w, [r]) for w, r in zip(works, raws)]
        return [_Work(rec, w, raws) for w in works]
    return batch_isend_irecv


@contextlib.contextmanager
def record_collectives():
    """Record every ``torch.distributed`` communication call made inside
    the block; yields the :class:`Recording`.

    For its duration each function of :data:`RAW_COLLECTIVES` on the
    ``torch.distributed`` module is replaced by a recording wrapper, and
    the work handles the calls return by wrappers whose ``wait()`` is
    recorded.  ``P2POp`` maps the wrapped ``isend`` / ``irecv`` back to
    torch's own, which ``batch_isend_irecv`` requires.  The call sites
    need no change, because every one looks the function up as
    ``dist.<name>`` when it runs (lanelint's A1 keeps them so).  Every
    attribute is restored on exit, also on an exception.  Not reentrant.
    """
    if _ACTIVE:
        raise RuntimeError("record_collectives is already active")
    rec = Recording()
    originals = {name: getattr(dist, name) for name in RAW_COLLECTIVES}
    originals["P2POp"] = dist.P2POp
    real_op = {}
    try:
        for name in RAW_COLLECTIVES:
            if name == "batch_isend_irecv":
                w = _wrap_batch(originals[name], originals, rec)
            else:
                w = _wrap(name, originals[name], rec)
            if name in ("isend", "irecv"):
                real_op[w] = originals[name]
            setattr(dist, name, w)
        p2p = originals["P2POp"]
        dist.P2POp = lambda op, *a, **kw: p2p(real_op.get(op, op), *a, **kw)
        _ACTIVE.append(rec)
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
        _ACTIVE.clear()


# ---------------------------------------------------------------------------
# overlap: node and lane phases in flight together
# ---------------------------------------------------------------------------

def overlap(foot: CommFootprint) -> list:
    """The (node op, lane op) pairs whose in-flight windows, from issue to
    completion, overlap, where at least one of the two was issued async:
    the §5 structure of a pipelined cell, one level's phase running
    while the other's is in flight.  An op never waited for is in flight
    to the end.  A synchronous op's window is its issue index, so two
    synchronous ops never overlap.  Groups of one process move nothing
    and take no part."""
    end = float("inf")

    def window(o):
        return o.issued, (end if o.completed is None else o.completed)

    node = [o for o in foot.ops if o.level == "node" and o.group_size > 1]
    lane = [o for o in foot.ops if o.level == "lane" and o.group_size > 1]
    pairs = []
    for a in node:
        a0, a1 = window(a)
        for b in lane:
            if not (a.async_op or b.async_op):
                continue
            b0, b1 = window(b)
            if a0 < b1 and b0 < a1:
                pairs.append((a, b))
    return pairs
