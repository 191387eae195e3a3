"""The family-agnostic ZeRO-3 sharded layer stack (the §5 recipe as a
runtime).

Counterpart of ``repro.models.blockstack``:

  ``StackLayout``  the flat layout of ONE stack of parameters (the layer
                   stack, or the embeddings/final-norm "extras" as a single
                   pseudo-layer): one row per layer, its leaves in
                   ``repro``'s flat order (``_tree.flatten``: sorted
                   keys), cast to f32 and back to each leaf's dtype.
  ``shard_stack``  the (L, B, n·N, s) f32 master of a stack; a process
                   keeps its (L, B·s) stripe (``launch/steps.py``).
  ``RowGather``    one stack's per-row gather, ``comm.prefetch_allgather``
                   then ``unflatten_row`` inside a ``torch.autograd.
                   Function`` whose backward is the transpose ``repro``
                   gets from JAX's AD: the ``lane_zero3`` reduce-scatter,
                   RS(node) → RS(lane) per block in the transposed block
                   order, of the row's flattened f32 cotangent.  It can
                   start a gather ahead (``start``) and take its result
                   later (``finish``): on a GPU the collectives run on a
                   stream of their own, and the layer that uses them
                   waits for it on the device.
  ``ShardedStack`` the stand-in for ``params["blocks"]`` inside a loss:
                   the shard rows and their gather, and the mode.
  ``scan_stack``   the layer loop: a one-layer prefetch (layer i+1's
                   gather started before layer i's body, taken when layer
                   i+1 starts), the blocking control, and the backward
                   re-gather (gather and body in one
                   ``torch.utils.checkpoint`` cell).
  ``scan_stack_cached``
                   the serving layer loop: per-layer inputs (the cache
                   rows) and stacked outputs, the same prefetch.
  ``BlockSpec``    what a model family declares to ride the stack, through
                   the ``comm`` registry (``register_block_stack``); the
                   specs live in ``models.transformer``.

Every rank issues the same collectives in the same order, the backward
and the re-gather's recompute included: autograd runs the same graph on
every rank in the same order, and NCCL hangs otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.comm.registry import (get_impl, has_impl, register_impl,
                                       strategies_for)
from repro_torch.core.costmodel import optimal_prefetch_blocks
from repro_torch.core.pipeline import pipelined_reduce_scatter_lane_
from .parallel import bound

__all__ = [
    "ShardedStack", "scan_stack", "scan_stack_cached", "RowGather", "StackLayout",
    "stack_layout", "shard_stack", "resolve_prefetch_blocks",
    "resolve_extras_prefetch_blocks", "BlockSpec",
    "register_block_stack", "block_stack_spec", "block_stack_families",
    "family_smoke_archs", "split_params",
]


# ---------------------------------------------------------------------------
# the flat layout of one stack
# ---------------------------------------------------------------------------

class StackLayout:
    """Flat layout of ONE stack of parameters: ``length`` rows (layers),
    each its leaves' elements in ``repro``'s flat order.

    ``stacked=True``: the tree is the port's list of per-layer dicts (the
    layer stack); ``stacked=False``: one pseudo-layer, the extras tree.
    ``decay`` says per leaf whether AdamW decays it: rank >= 2 in
    ``repro``'s layout, where a layer's leaf has the stack's L axis (so
    every leaf of the layer stack), as ``optim.adamw`` ranks them.
    Only shapes and dtypes are read, so a template on the ``meta`` device
    will do.
    """

    def __init__(self, metas, paths, decay, skeleton, row_elems: int,
                 length: int, stacked: bool):
        self.metas = metas              # ((row shape, dtype) per leaf)
        self.paths = paths              # each leaf's path in a row's tree
        self.decay = decay              # (bool per leaf)
        self._skeleton = skeleton       # a row's dicts and lists
        self.row_elems = row_elems      # D: unpadded flat size of a row
        self.length = length            # L: rows in the stack
        self.stacked = stacked

    def row_leaves(self, vec, dtype=None) -> list:
        """One row's leaves from its (padded) flat f32 vector, each a new
        tensor in its stored dtype (in ``dtype`` where given: the f32
        moments of a row)."""
        out, ofs = [], 0
        for shape, dt in self.metas:
            sz = math.prod(shape)
            out.append(vec[ofs:ofs + sz].view(shape).to(dtype or dt,
                                                        copy=True))
            ofs += sz
        return out

    def tree_of(self, leaves):
        """A row's tree with ``leaves`` (in layout order) at its paths."""
        tree = _tree.tree_map(lambda _: None, self._skeleton)
        for path, leaf in zip(self.paths, leaves):
            _tree.set_path(tree, path, leaf)
        return tree

    def unflatten_row(self, vec, dtype=None):
        """Padded flat f32 row -> the row's parameter tree, every leaf cast
        back to its dtype (or to ``dtype``)."""
        return self.tree_of(self.row_leaves(vec, dtype))

    def flatten_row(self, tree, pad_to: int = 1, *, out=None):
        """One row's tree -> its f32 flat vector, zero-padded to a
        multiple of ``pad_to`` (into ``out`` where given)."""
        flat = _tree.flatten(tree)
        D = self.row_elems
        if out is None:
            out = torch.empty(D + (-D) % pad_to, dtype=torch.float32,
                              device=flat[0][1].device)
        ofs = 0
        for (_, leaf), (shape, _) in zip(flat, self.metas):
            if tuple(leaf.shape) != tuple(shape):
                raise ValueError(f"leaf of shape {tuple(leaf.shape)} where "
                                 f"the layout has {tuple(shape)}")
            out[ofs:ofs + leaf.numel()].copy_(leaf.detach().reshape(-1))
            ofs += leaf.numel()
        out[D:].zero_()
        return out

    def flatten(self, tree, pad_to: int = 1):
        """The (L, D_pad) f32 row matrix of ``tree`` (a list of layers when
        stacked), zero-padded so D_pad % pad_to == 0."""
        rows = tree if self.stacked else [tree]
        if len(rows) != self.length:
            raise ValueError(f"{len(rows)} rows, the layout has "
                             f"{self.length}")
        D = self.row_elems
        dev = _tree.leaves(rows[0])[0].device
        mat = torch.empty((self.length, D + (-D) % pad_to),
                          dtype=torch.float32, device=dev)
        for r, row in enumerate(rows):
            self.flatten_row(row, out=mat[r])
        return mat

    def decay_mask(self, pad_to: int, *, dtype=torch.float32, device=None):
        """Per-element 0/1 mask over ONE flat row padded to ``pad_to``
        elements: 1 exactly where AdamW decays; padding 0."""
        m = torch.zeros(pad_to, dtype=dtype, device=device)
        ofs = 0
        for (shape, _), d in zip(self.metas, self.decay):
            sz = math.prod(shape)
            if d:
                m[ofs:ofs + sz] = 1
            ofs += sz
        return m


def stack_layout(tree, *, stacked: bool = True) -> StackLayout:
    """The :class:`StackLayout` of ``tree``: a list of layer dicts
    (``stacked``) or one pseudo-layer's tree."""
    if stacked:
        if not tree:
            raise ValueError("cannot build a StackLayout over an empty tree")
        row, length = tree[0], len(tree)
        shapes = [tuple(l.shape) for l in _tree.leaves(row)]
        for lp in tree[1:]:
            if [tuple(l.shape) for l in _tree.leaves(lp)] != shapes:
                raise ValueError("stacked layers disagree on their leaves")
    else:
        row, length = tree, 1
    flat = _tree.flatten(row)
    if not flat:
        raise ValueError("cannot build a StackLayout over an empty tree")
    metas = tuple((tuple(l.shape), l.dtype) for _, l in flat)
    paths = tuple(p for p, _ in flat)
    decay = tuple(stacked or l.ndim + _tree.is_stacked(p) >= 2
                  for p, l in flat)
    elems = sum(math.prod(s) for s, _ in metas)
    return StackLayout(metas, paths, decay,
                       _tree.tree_map(lambda _: None, row), elems, length,
                       stacked)


def resolve_prefetch_blocks(row_elems: int, n: int, N: int,
                            override: int = 0) -> int:
    """The B every lane_zero3 call site uses (shard layout, optimizer
    state, per-layer gather).  override > 0 wins; -1 (the blocking
    control) gathers monolithically, B = 1; otherwise the cost model on
    the per-process stripe.  Capped so each block keeps a row per
    process."""
    p = max(n * N, 1)
    if override > 0:
        b = override
    elif override < 0:
        b = 1
    else:
        b = optimal_prefetch_blocks(row_elems * 4 / p)
    return max(1, min(b, max(1, row_elems // p)))


def resolve_extras_prefetch_blocks(row_elems: int, n: int, N: int,
                                   override: int = 0) -> int:
    """B of the extras pseudo-layer: its row (vocab·d embeddings) is not a
    layer's, so a positive ``--fsdp-prefetch`` tuned for the layers is
    not inherited; only the blocking control (-1) passes through, else
    the cost model on the extras row's own stripe."""
    return resolve_prefetch_blocks(row_elems, n, N,
                                   -1 if override < 0 else 0)


def shard_stack(tree, n: int, N: int, fsdp_prefetch: int = 0, *,
                stacked: bool = True):
    """The (L, B, n·N, s) f32 master of one stack, and B: process
    (node_rank i, lane_rank j) keeps ``[:, :, i·N + j]``, its (L, B·s)
    stripe.  ``stacked=False`` is the extras pseudo-layer (its B from
    :func:`resolve_extras_prefetch_blocks`)."""
    layout = stack_layout(tree, stacked=stacked)
    resolve = resolve_prefetch_blocks if stacked \
        else resolve_extras_prefetch_blocks
    B = resolve(layout.row_elems, n, N, fsdp_prefetch)
    p = max(n * N, 1)
    flat = layout.flatten(tree, pad_to=B * p)
    s = flat.shape[1] // (B * p)
    return flat.view(layout.length, B, p, s), B


# ---------------------------------------------------------------------------
# the per-row gather and its transpose
# ---------------------------------------------------------------------------

_STREAMS: dict = {}


def _gather_stream(device) -> "torch.cuda.Stream":
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class _Pending:
    """A started gather: its output and, on a GPU, the event that marks
    it done on the gather stream."""

    def __init__(self, full, event=None):
        self.full, self.event = full, event

    def wait(self):
        """The gathered row, ready for the current stream."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.full.device)
            cur.wait_event(self.event)
            self.full.record_stream(cur)
            self.event = None
        return self.full


class _RowGatherFunction(torch.autograd.Function):
    """shard row -> the row's leaves; backward: the reduce-scatter."""

    @staticmethod
    def forward(ctx, row, gather, pending):
        ctx.gather, ctx.numel = gather, row.numel()
        return tuple(gather.layout.row_leaves(pending.wait()))

    @staticmethod
    def backward(ctx, *grads):
        return ctx.gather.transpose(grads, ctx.numel), None, None


class RowGather:
    """The ZeRO-3 gather of one stack's rows over ``comm``:
    ``comm.prefetch_allgather(row, num_blocks)`` then the layout's
    ``unflatten_row``, differentiable in the row.  ``gathers`` counts the
    gathers issued (the re-gather's recompute included)."""

    def __init__(self, comm, layout: StackLayout, num_blocks: int):
        self.comm, self.layout, self.num_blocks = comm, layout, num_blocks
        self.gathers = 0

    def start(self, row) -> _Pending:
        """Issue the gather of ``row``: on a GPU on the gather stream
        (after the work queued so far on the current one), so that it
        runs beside what the current stream does next."""
        self.gathers += 1
        row = row.detach()
        if not row.is_cuda:
            return _Pending(self.comm.prefetch_allgather(
                row, num_blocks=self.num_blocks))
        stream = _gather_stream(row.device)
        stream.wait_stream(torch.cuda.current_stream(row.device))
        with torch.cuda.stream(stream):
            full = self.comm.prefetch_allgather(row,
                                                num_blocks=self.num_blocks)
            event = torch.cuda.Event()
            event.record(stream)
        return _Pending(full, event)

    def finish(self, pending: _Pending, row):
        """The row's parameter tree from its started gather."""
        return self.layout.tree_of(
            _RowGatherFunction.apply(row, self, pending))

    def __call__(self, row):
        return self.finish(self.start(row), row)

    def detached(self, row) -> list:
        """The row's leaves, gathered outside autograd (the extras, whose
        transpose the train step applies itself)."""
        return self.layout.row_leaves(self.start(row).wait())

    def transpose(self, leaf_grads, numel: int):
        """The gradient of a (``numel``,) shard row from its leaves'
        gradients (None = zero): flattened to f32 in layout order, padded,
        reduce-scattered over the node then the lane level block by block
        (``pipelined_reduce_scatter_lane_``).  Summed over the processes,
        not averaged, as ``repro``'s transpose."""
        topo = self.comm.topo
        g0 = next(g for g in leaf_grads if g is not None)
        cot = torch.empty(numel * topo.p(), dtype=torch.float32,
                          device=g0.device)
        ofs = 0
        for g, (shape, _) in zip(leaf_grads, self.layout.metas):
            sz = math.prod(shape)
            if g is None:
                cot[ofs:ofs + sz].zero_()
            else:
                cot[ofs:ofs + sz].copy_(g.reshape(-1))
            ofs += sz
        cot[ofs:].zero_()
        return pipelined_reduce_scatter_lane_(cot, topo,
                                              num_blocks=self.num_blocks)


# ---------------------------------------------------------------------------
# the stand-in and the layer loop
# ---------------------------------------------------------------------------

class ShardedStack:
    """Stand-in for ``params["blocks"]`` when the stack is ZeRO-3 sharded:
    each process holds its 1/p stripe of every layer's flat weights and
    the recipe to gather one layer on demand.

    shards   this process's rows, one per layer (a list of (B·s,) tensors
             or an (L, B·s) tensor); the loss is differentiated in them.
    gather   row -> one layer's parameter tree: a :class:`RowGather`, or
             any callable (then gathered when called).
    prefetch True: layer i+1's gather starts before layer i's body.
             False: each layer's body takes its own gather (the blocking
             control).
    regather True: each layer's gather runs with its body inside one
             checkpoint cell, so the backward gathers again and keeps no
             gathered weights between the passes.
    """

    def __init__(self, shards, gather, *, prefetch: bool = True,
                 regather: bool = False):
        if regather and not prefetch:
            raise ValueError(
                "regather=True is incompatible with prefetch=False (the "
                "blocking negative control); drop one of the two")
        self.shards = shards
        self.gather = gather
        self.prefetch = prefetch
        self.regather = regather


def _start(gather, row):
    return gather.start(row) if isinstance(gather, RowGather) else gather(row)


def _finish(gather, pending, row):
    return gather.finish(pending, row) if isinstance(gather, RowGather) \
        else pending


def scan_stack(stack: ShardedStack, h, body):
    """Layer loop over ZeRO-3 shards.

    ``body(h, layer_params, layer_idx) -> (h', aux)`` is the block body
    (``aux`` a scalar, tensor or float).  Returns ``(h, aux (L,) f32)``.
    Prefetch: layer 0's gather blocks; layer i+1's gather starts before
    layer i's body and is taken when layer i+1 starts, so exactly L
    gathers run per forward.  Regather: gather and body in one
    checkpoint cell per layer (L more gathers in the backward).
    Blocking: each body takes its own gather.
    """
    shards, gather = stack.shards, stack.gather
    L = len(shards)
    aux = []
    if stack.regather:
        # the recompute runs in the backward, under the forward's context
        cell = bound(lambda hh, row, i: body(hh, gather(row), i))
        for i in range(L):
            h, a = checkpoint(cell, h, shards[i], i, use_reentrant=False,
                              preserve_rng_state=False)
            aux.append(a)
    elif not stack.prefetch:
        for i in range(L):
            w = _finish(gather, _start(gather, shards[i]), shards[i])
            h, a = body(h, w, i)
            aux.append(a)
    else:
        pending = _start(gather, shards[0])
        for i in range(L):
            w = _finish(gather, pending, shards[i])
            if i + 1 < L:
                pending = _start(gather, shards[i + 1])
            h, a = body(h, w, i)
            aux.append(a)
    if not any(isinstance(a, torch.Tensor) for a in aux):
        return h, torch.tensor(aux, dtype=torch.float32).to(h.device)
    return h, torch.stack([
        a.float().reshape(()) if isinstance(a, torch.Tensor)
        else h.new_tensor(float(a), dtype=torch.float32) for a in aux])


def _row(xs, i):
    """Row ``i`` of every leaf of ``xs`` (dicts, tuples, tensors; None)."""
    if xs is None:
        return None
    if isinstance(xs, dict):
        return {k: _row(v, i) for k, v in xs.items()}
    if isinstance(xs, (tuple, list)):
        return type(xs)(_row(v, i) for v in xs)
    return xs[i]


def _stack_rows(ys):
    """The rows a body returned, stacked leaf by leaf along a new axis 0
    (None when the body returns None)."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_rows([y[k] for y in ys]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_rows([y[j] for y in ys])
                           for j in range(len(first)))
    return torch.stack(ys)


def scan_stack_cached(stack, h, xs, body):
    """The serving layer loop, ``repro``'s ``scan_stack_cached``: per-layer
    inputs and stacked outputs, over a ``ShardedStack`` (``lane_zero3``
    hosting) or the replicated list of layers (no gather).

    ``body(h, layer_params, xs_row) -> (h', ys_row)``: ``xs`` is a tree
    (dicts, tuples) whose every leaf has a leading L axis, and ``xs_row``
    its row i (views: the cached bodies write the cache rows in place);
    the ``ys_row`` (a tree of tensors, or None) come back stacked along a
    new axis 0 (the audio prefill's cross-attention K/V).  No autograd, no
    aux, no regather: over a ``ShardedStack``, layer i+1's gather starts
    (on a GPU, on the gather stream) before layer i's body, so exactly L
    gathers run per call; ``stack.prefetch=False`` gathers each layer as
    its body needs it.  Returns ``(h, ys)``."""
    sharded = isinstance(stack, ShardedStack)
    L = len(stack.shards) if sharded else len(stack)
    ys = []
    pending = _start(stack.gather, stack.shards[0]) \
        if sharded and stack.prefetch else None
    for i in range(L):
        if not sharded:
            w = stack[i]
        else:
            shards, gather = stack.shards, stack.gather
            if pending is None:
                pending = _start(gather, shards[i])
            w = _finish(gather, pending, shards[i])
            pending = _start(gather, shards[i + 1]) \
                if stack.prefetch and i + 1 < L else None
        h, y = body(h, w, _row(xs, i))
        ys.append(y)
    return h, _stack_rows(ys)


# ---------------------------------------------------------------------------
# per-family block specs (registered through the comm registry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """What one model family declares to train through the sharded stack.

    stack_key        top-level params key of the layer stack.
    replicated_keys  top-level keys that stay replicated (the Zamba2
                     weight-shared attention block, applied ``groups``
                     times a forward); their gradients sync through the
                     bucketed ``lane`` path.  Every OTHER key becomes the
                     extras pseudo-layer, gathered once a step.
    make_body        ``make_body(cfg, params, *, positions, enc_out,
                     remat) -> body(h, layer_params, layer_idx) ->
                     (h', aux)``.
    needs_extra_embeds
                     the forward needs vlm patches / audio frames, which
                     the training driver does not make.
    """
    family: str
    make_body: Callable
    stack_key: str = "blocks"
    replicated_keys: tuple = ()
    needs_extra_embeds: bool = False


def register_block_stack(family: str, **kw):
    """Sugar for ``register_impl("block_stack", family, auto_ok=False)``
    on a spec factory ``fn(cfg) -> BlockSpec``."""
    return register_impl("block_stack", family, auto_ok=False, **kw)


def block_stack_spec(cfg) -> BlockSpec:
    """The registered :class:`BlockSpec` of ``cfg.family``."""
    import repro_torch.models.transformer  # noqa: F401 - registers them
    if not has_impl("block_stack", cfg.family):
        raise ValueError(
            f"model family {cfg.family!r} has no registered block_stack "
            f"spec, so it cannot train through the lane_zero3 sharded "
            f"stack; registered families: {block_stack_families()}")
    return get_impl("block_stack", cfg.family).fn(cfg)


def block_stack_families() -> tuple:
    """Every family with a spec, in registration order."""
    import repro_torch.models.transformer  # noqa: F401 - registers them
    return strategies_for("block_stack")


# the smoke arch of each family, as repro pins them (a family absent here
# takes its smallest smoke arch by parameters)
_PREFERRED_SMOKE_ARCHS = {
    "dense": "llama3.2-3b",
    "moe": "granite-moe-3b-a800m",
    "ssm": "mamba2-780m",
    "hybrid": "zamba2-7b",
    "vlm": "llava-next-mistral-7b",
    "audio": "whisper-large-v3",
}


def family_smoke_archs(*, driver_trainable_only: bool = False) -> dict:
    """family -> smoke arch id, for every family with a spec;
    ``driver_trainable_only`` drops the families that need extra
    embeddings."""
    from repro_torch.configs import all_archs, resolve
    by_family: dict = {}
    for arch in all_archs():
        cfg = resolve(arch, smoke=True)
        cur = by_family.get(cfg.family)
        if cur is None or cfg.param_count() < cur[1]:
            by_family[cfg.family] = (arch, cfg.param_count())
    missing = [f for f in block_stack_families() if f not in by_family]
    if missing:
        raise ValueError(
            f"block_stack families with no registered arch: {missing}")
    registered = set(all_archs())
    out = {}
    for fam in block_stack_families():
        arch = _PREFERRED_SMOKE_ARCHS.get(fam)
        if arch not in registered:
            arch = by_family[fam][0]
        cfg = resolve(arch, smoke=True)
        if cfg.family != fam:
            raise ValueError(
                f"preferred smoke arch {arch!r} is family "
                f"{cfg.family!r}, not {fam!r}")
        if driver_trainable_only and block_stack_spec(cfg).needs_extra_embeds:
            continue
        out[fam] = arch
    return out


def split_params(spec: BlockSpec, params: dict):
    """(stack, extras, replicated) of a params dict per the family spec:
    ``extras`` is everything that is neither the stack nor replicated."""
    if spec.stack_key not in params:
        raise ValueError(
            f"params have no {spec.stack_key!r} stack (keys: "
            f"{sorted(params)})")
    stack = params[spec.stack_key]
    repl = {k: params[k] for k in spec.replicated_keys if k in params}
    extras = {k: v for k, v in params.items()
              if k != spec.stack_key and k not in spec.replicated_keys}
    return stack, extras, repl
