"""The train steps, on one process or across ranks: the replicated step
and the ZeRO steps.

Counterpart of ``repro.launch.steps``' ``train_step`` flavors, with its
``_make_loss``, ``_accum_dtype``, ``_microbatched`` and ``_adamw_flat``.
Each flavor is one ``("train_step", strategy)`` registry cell, under
``repro``'s eight names in its order (``native``, ``lane``,
``lane_pipelined``, ``lane_int8`` and ``auto`` the replicated step, then
``lane_quorum``, ``lane_zero1``, ``lane_zero3``), and keeps the parameter
layout its strategy registers (``comm.layout``):

  replicated  value and gradient of ``loss_fn`` (optionally over
              microbatches), the gradient sync, then AdamW.  Across
              ranks the step averages the loss over the communicator and
              calls ``comm.grad_sync(grads, strategy=eff)`` between the
              backward and AdamW, ``eff = "native"`` on a single batch
              axis, as ``repro`` does; on one process (no comm) both are
              the identity.
  zero1       (``lane_zero1``) the same backward, then the node-sharded
              sync (RS(node) → AR(lane), no all-gather), AdamW on this
              process's flat f32 shard with its sharded moments (the
              global norm one scalar all-reduce over the node group, the
              decay per element), and the all-gather moved past the
              optimizer, into one flat f32 buffer cast back into the
              parameters.  On a single batch axis it is the replicated
              step, as in ``repro``.
  zero3       (``lane_zero3``) the layer stack and the extras (everything
              but the stack and the family's replicated keys) live as
              this process's 1/p f32 master stripes; the forward gathers
              each layer inside ``models.blockstack.scan_stack`` (prefetch,
              blocking or regather: ``fsdp_prefetch`` / ``fsdp_regather``)
              and the extras once a step, the gathers' transposes
              reduce-scatter the gradients, and AdamW runs on the stripes.
              It needs two batch levels and raises on one, as ``repro``.

The third parallelism axis (``repro``'s ``_parallel_kwargs``): every
step's loss runs under ``models.parallel.parallel_context``.  With
``model_parallel`` > 1 the MLP is ``mlp_tp`` over the topology's model
group (``topo.model``, a degenerate n = 1 communicator), and the TP
weights' zero-padded gradient blocks are summed over it (one all-reduce,
adding zeros: ``_tp_assemble_tree``; under ``lane_zero3`` a masked sum of
the stripes, ``_tp_row_mask``).  With ``expert_parallel`` the MoE is
``moe_block_ep`` over the batch communicator: the replicated layouts slice
their whole experts by rank, and ``lane_zero3`` keeps the experts out of
the flat stack (``split_expert_stack``) as this process's (L, E/p, ...)
f32 ``experts``, never gathered, with their own AdamW moments.

Unlike ``repro``, which is functional, every step updates its state in
place: at llama3.2-3b each functional copy is 12.85 GB of f32.  The
flat AdamW runs over chunks, so its temporaries stay small.

Every flavor's step runs inside ``repro_torch.obs`` spans, which cost
one flag check each when no profiler records:

  train_step              the whole call (``build_train_step`` wraps
                          every flavor's ``step``)
  train_step/forward      the loss
  train_step/backward     the backward of ``torch.autograd.grad``, from
                          its first node to its end, on the thread that
                          runs it (autograd's device thread for CUDA
                          tensors: ``obs.backward_until_end``), so that
                          the range holds the backward's kernels
  train_step/grad_sync    the loss mean and the gradient sync
  train_step/loss_mean    the loss's mean over the ranks (``_mean_loss``,
                          ``_node_mean`` and the quorum mean): the small
                          all-reduce that is the first collective after
                          the backward; its device time is a lower bound
                          on the wait for the slowest rank, whose rest
                          the sync's NCCL kernels hold
  train_step/optimizer    AdamW

and inside them the sync's (``optim/gradsync.py``), the MoE block's
(``models/moe.py``) and the kernels' backwards (``attention_backward``,
``ssd_backward``).
"""
from __future__ import annotations

import functools
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree, obs
from repro_torch._device import resolve_device
from repro_torch.checkpoint import (REPLICATED, CheckpointCorruptError,
                                    Zero1CheckpointLayout,
                                    Zero3CheckpointLayout, committed_steps,
                                    concat_flat_order, load_canonical,
                                    peek_manifest, restore_checkpoint,
                                    split_flat_order)
from repro_torch.checkpoint.store import host_array, to_torch
from repro_torch.comm import LaneComm
from repro_torch.comm.layout import param_layout_kind
from repro_torch.comm.registry import get_impl, register_impl
from repro_torch.core import collectives as C
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.lane import LaneTopology
from repro_torch.models import init_model, make_train_step
from repro_torch.models.parallel import parallel_context
from repro_torch.models.blockstack import (
    RowGather, ShardedStack, block_stack_spec,
    resolve_extras_prefetch_blocks, resolve_prefetch_blocks, shard_stack,
    split_params, stack_layout,
)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_lr, global_norm)
from repro_torch.optim.gradsync import (
    _flatten_bucket, _unflatten_bucket, decay_mask_flat,
    resolve_num_buckets, zero1_param_shard, zero1_unshard, zero3_param_shard,
)


def _local_topology() -> LaneTopology:
    """The 1 x 1 topology of one process with no started world."""
    return LaneTopology(1, 1, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None, node_ranks=[0],
                        lane_ranks=[0], ranks=[0])


def _model_comm(run: RunConfig, comm: "LaneComm | None"):
    """The model-axis communicator of a TP run (None at tp = 1): the
    degenerate n = 1 decomposition of the model group
    (``comm.topo.model``), its all-gathers resolving through the same
    (collective, strategy) cells and config as every other call."""
    tp = run.model_parallel
    if tp <= 1:
        return None
    mt = None if comm is None else comm.topo.model
    if mt is None or mt.p() != tp:
        raise ValueError(
            f"model_parallel={tp} needs a model axis of that size "
            f"(this process's model group has "
            f"{1 if mt is None else mt.p()})")
    return LaneComm(mt, comm.cfg)


def _parallel_kwargs(run: RunConfig, comm: "LaneComm | None",
                     tp_comm: "LaneComm | None") -> dict:
    """The ``parallel_context`` keywords of the run's third axis (empty:
    no TP and no EP, the default path).

    TP gathers over ``tp_comm`` (:func:`_model_comm`); EP routes through
    the batch communicator ``comm`` itself (every process owns experts),
    or, on one process, the 1 x 1 one."""
    pc: dict = {}
    if tp_comm is not None:
        pc.update(tp=run.model_parallel, tp_comm=tp_comm)
    if run.expert_parallel:
        ep_comm = comm if comm is not None else LaneComm(_local_topology())
        E, psz = run.model.num_experts, ep_comm.topo.p()
        if E % psz:
            raise ValueError(
                f"expert_parallel needs num_experts={E} divisible by the "
                f"batch-axes chip count p={psz}")
        pc.update(ep=True, ep_comm=ep_comm, ep_blocks=run.ep_blocks)
    return pc


def _make_loss(run: RunConfig, comm: "LaneComm | None" = None,
               tp_comm: "LaneComm | None" = None):
    """``lf(params, tokens, labels, extra) -> loss``, under the run's
    ``parallel_context`` when it has a third axis.  A
    ``params["ep_experts"]`` entry (``lane_zero3``'s local experts, one
    dict per layer) is taken off the params and carried on the context
    for the stack body."""
    base = make_train_step(run.model, remat=run.remat)
    pc = _parallel_kwargs(run, comm, tp_comm)
    if not pc:
        return base

    def lf(params, tokens, labels, extra):
        params = dict(params)
        experts = params.pop("ep_experts", None)
        with parallel_context(**pc, ep_experts=experts):
            return base(params, tokens, labels, extra)
    return lf


def _value_and_grad(lf):
    """``vg(params, tokens, labels, extra) -> (loss, grads)``: ``grads``
    mirrors ``params``, each leaf in its parameter's dtype (zero where the
    loss does not reach it), as ``jax.value_and_grad`` gives them."""
    def vg(params, tokens, labels, extra):
        leaves = _tree.leaves(params)
        with obs.span("train_step/forward"):
            loss = lf(params, tokens, labels, extra)
        grads = torch.autograd.grad(
            obs.backward_until_end("train_step/backward", loss), leaves,
            allow_unused=True, materialize_grads=True)
        return loss.detach(), _tree.unflatten(params, grads)
    return vg


def _accum_dtype(run: RunConfig) -> torch.dtype:
    return torch.bfloat16 if run.accum_dtype == "bfloat16" else torch.float32


def _microbatched(vg, mb: int, accum_dtype: torch.dtype):
    """``vg`` over ``mb`` microbatches of the batch, one after the other:
    the losses summed in f32 and the gradients in ``accum_dtype``, both
    divided by ``mb`` at the end, as ``repro``'s ``_microbatched``.
    ``mb <= 1`` returns ``vg`` itself.  Each microbatch's gradients come
    from their own ``torch.autograd.grad`` (``.backward()`` would sum them
    in the parameters' dtype, bf16 in training)."""
    if mb <= 1:
        return vg

    def wrapped(params, tokens, labels, extra):
        B = tokens.shape[0]
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch={mb}")
        sh = lambda a: None if a is None else \
            a.reshape(mb, B // mb, *a.shape[1:])
        toks, labs, ex = sh(tokens), sh(labels), sh(extra)
        lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        gsum = None
        for i in range(mb):
            li, gi = vg(params, toks[i], labs[i], None if ex is None
                        else ex[i])
            lsum = lsum + li
            gi = [g.to(accum_dtype) for g in _tree.leaves(gi)]
            gsum = gi if gsum is None else \
                [a.add_(b) for a, b in zip(gsum, gi)]
        return lsum / mb, _tree.unflatten(params,
                                          [g.div_(mb) for g in gsum])
    return wrapped


def layout_kind(run: RunConfig, single: bool = True) -> str:
    """The parameter layout the step for ``run`` keeps: ``lane_zero1`` on
    a single batch axis is the replicated step, as ``repro``'s
    ``LaneComm.param_layout`` answers."""
    kind = param_layout_kind(run.gradsync)
    return "replicated" if kind == "zero1" and single else kind


def build_train_step(run: RunConfig, opt: AdamWConfig,
                     comm: "LaneComm | None" = None, *, single: bool = True):
    """``step(params, opt_state, tokens, labels, extra=None) -> (loss,
    params, opt_state)``; ``params`` and ``opt_state`` come from
    ``init_lane_train_state`` (or ``init_train_state``) and are updated in
    place.  ``extra``: the vlm patches or audio frames of the batch, or
    None.  ``step.full_params(params)`` is the whole parameter tree of
    the state (gathered under zero3).

    The flavor is the ``("train_step", run.gradsync)`` registry cell
    (``comm.strategies_for("train_step")``; the registrations stand
    beside their builders below), called as ``fn(run, opt, comm,
    single)``.  ``comm``: None on one process; across ranks, the
    ``LaneComm`` of the world's topology
    (``launch.mesh.make_lane_topology``), each rank passing its own rows
    of the global batch.  ``single``: the topology has one batch axis,
    where the replicated strategies degrade to ``"native"``,
    ``lane_zero1`` to the replicated step, and ``lane_zero3`` raises."""
    return _spanned(get_impl("train_step", run.gradsync).fn(
        run, opt, comm, single))


def _spanned(step):
    """``step``, each call of it under the span ``train_step``; its
    attributes (``full_params``, ...) are copied to the wrapper."""
    @functools.wraps(step)
    def spanned(*args, **kw):
        with obs.span("train_step"):
            return step(*args, **kw)
    return spanned


def _mean_loss(comm: LaneComm, loss):
    with obs.span("train_step/loss_mean"):
        return comm.allreduce(loss.reshape(1), strategy="native")[0] \
            / comm.topo.p()


def _build_replicated(run, opt, comm, single):
    """Replicated-parameter step: full gradient sync, then tree AdamW."""
    tp_comm = _model_comm(run, comm)
    vg = _microbatched(_value_and_grad(_make_loss(run, comm, tp_comm)),
                       run.microbatch, _accum_dtype(run))
    eff = "native" if single else run.gradsync

    def step(params, opt_state, tokens, labels, extra=None):
        loss, grads = vg(params, tokens, labels, extra)
        if comm is not None:
            with obs.span("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                if tp_comm is not None:
                    _tp_assemble_tree(grads, tp_comm)
                grads = comm.grad_sync(grads, strategy=eff)
        with obs.span("train_step/optimizer"):
            params, opt_state = adamw_update(opt, grads, opt_state, params)
        return loss, params, opt_state
    step.full_params = lambda params: params
    return step


for _s in ("native", "lane", "lane_pipelined", "lane_int8", "auto"):
    register_impl("train_step", _s, auto_ok=False)(_build_replicated)


@register_impl("train_step", "lane_quorum", auto_ok=False)
def _build_quorum(run, opt, comm, single=True):
    """The quorum-degraded replicated step, the DEGRADED rung of the
    recovery ladder: ``step(params, opt_state, tokens, labels, extra=None,
    quorum_mask=None)``.

    The replicated step with a trailing ``quorum_mask``: the watchdog's
    0/1 float32 vector over the lane (pod) level, on the host, of which
    each process takes its pod's bit ``mask[topo.lane_rank()]``.  The
    gradients go through the ``lane_quorum`` sync (masked pods contribute
    zero, the mean rescales by the live count) and the loss degrades the
    same way: the node mean, then ``quorum_mean`` over the lane.  A masked
    process still runs its forward and backward.  With every pod masked
    the divisor is 1, the loss and the gradient exactly 0, and AdamW still
    moves the parameters by its moments, as in ``repro``.  With no mask
    (or all ones) the step is the full quorum, bit-identical to ``lane``
    on power-of-two pod counts.  On one process (no comm) the lane is
    this process alone.  ``step.needs_quorum_mask`` tells the training
    loop to pass the mask."""
    from repro_torch.runtime.straggler import quorum_mean
    vg = _microbatched(_value_and_grad(_make_loss(run)), run.microbatch,
                       _accum_dtype(run))

    def step(params, opt_state, tokens, labels, extra=None,
             quorum_mask=None):
        loss, grads = vg(params, tokens, labels, extra)
        q = 0 if comm is None else comm.topo.lane_rank()
        c = 1.0 if quorum_mask is None else float(quorum_mask[q])
        with obs.span("train_step/grad_sync"):
            if comm is None:
                # a lane of one: sum(x·c) / max(c, 1)
                den = max(c, 1.0)
                loss = loss * c / den
                for g in _tree.leaves(grads):
                    g.mul_(c).div_(den)
            else:
                topo = comm.topo
                with obs.span("train_step/loss_mean"):
                    if topo.n() > 1:
                        loss = _node_mean(topo, loss)
                    loss = quorum_mean(loss, topo, c)
                grads = comm.grad_sync(grads, strategy="lane_quorum",
                                       contributing=c)
        with obs.span("train_step/optimizer"):
            params, opt_state = adamw_update(opt, grads, opt_state, params)
        return loss, params, opt_state
    step.full_params = lambda params: params
    step.needs_quorum_mask = True
    return step


# the FFN weights: under an "mlp", the leaves the tensor-parallel MLP
# partitions, whose gradients mlp_tp computes as zero-padded column blocks
# per model rank (every other gradient is already the same on every model
# rank, its backward gathering the input's cotangent whole); under a
# "moe", the (L, E, ...) experts the expert-parallel zero3 state keeps OUT
# of the gathered flat stack (the router stays in it: its gradient is
# dense over the tokens, and every process routes its own)
_FFN_KEYS = ("w_up", "w_gate", "w_down")


def _is_tp_leaf(keys) -> bool:
    return "mlp" in keys and keys[-1] in _FFN_KEYS


def _tp_assemble_tree(grads, tp_comm) -> None:
    """Sum the TP MLP weight gradients over the model group, in place.
    Each model rank holds the zero-padded column block of its slice of
    the replicated gradient (``mlp_tp``'s backward), so the sum
    concatenates disjoint blocks exactly; the other leaves pass."""
    group = tp_comm.topo.group
    works = [dist.all_reduce(g, group=group, async_op=True)
             for path, g in _tree.flatten(grads) if _is_tp_leaf(path)]
    for w in works:
        w.wait()


def _tp_row_mask(layout) -> torch.Tensor:
    """Bool over ONE unpadded flat row of ``layout``: True exactly on the
    TP-partitioned MLP weights' elements (layout order)."""
    parts = [torch.full((math.prod(shape),), _is_tp_leaf(path))
             for path, (shape, _) in zip(layout.paths, layout.metas)]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.bool)


def split_expert_stack(stack):
    """A MoE layer stack (the port's list of layer dicts) -> ``(the stack
    without the experts, experts)``: ``experts`` one dict per layer of the
    moe FFN weights, in their natural (E, ...) shapes (the expert-parallel
    state shards them over E across the batch ranks, in global-rank
    order, and never gathers them); the stack keeps the router and
    everything else for the flat 1/p layout."""
    if not stack or "moe" not in stack[0]:
        raise ValueError(
            f"expert_parallel needs a 'moe' stack entry (stack keys: "
            f"{sorted(stack[0]) if stack else []})")
    rest, experts = [], []
    for lp in stack:
        moe = lp["moe"]
        ex = {k: moe[k] for k in _FFN_KEYS if k in moe}
        if not ex:
            raise ValueError("'moe' stack entry has no expert FFN weights")
        rest.append({**lp, "moe": {k: v for k, v in moe.items()
                                   if k not in ex}})
        experts.append(ex)
    return rest, experts


def _node_mean(topo, loss):
    """The mean of ``loss`` over the node group."""
    t = loss.reshape(1).clone()
    dist.all_reduce(t, group=topo.node_group)
    return t[0] / topo.n()


# ---------------------------------------------------------------------------
# the flat sharded AdamW (ZeRO-1 / ZeRO-3)
# ---------------------------------------------------------------------------

_CHUNK = 1 << 24          # elements per pass of the flat AdamW and norms


def _sq_sum(t):
    """Sum of squares of the flat f32 ``t``, a chunk at a time (no
    full-size temporary)."""
    return sum(c.square().sum() for c in t.split(_CHUNK))


@torch.no_grad()
def _adamw_flat(opt: AdamWConfig, g, m, v, p, count: int, *, scale=None,
                decay_mask=None) -> None:
    """AdamW on a flat f32 shard, in place on ``p``, ``m``, ``v`` (and
    ``g``, scaled): ``repro``'s ``_adamw_flat`` with the step ``count``
    already advanced by the caller.  ``scale``: the clip factor from the
    TRUE global norm, computed by the caller over every shard; None skips
    clipping.  ``decay_mask``: the 0/1 (or bool) mask of the elements
    AdamW decays (``decay_mask_flat``); None decays every element."""
    lr = cosine_lr(opt, count)
    f = np.float32
    c1 = float(f(1) - f(opt.b1) ** f(count))
    c2 = float(f(1) - f(opt.b2) ** f(count))
    for a in range(0, p.numel(), _CHUNK):
        sl = slice(a, a + _CHUNK)
        gc, mc, vc, pc = g[sl], m[sl], v[sl], p[sl]
        if scale is not None:
            gc.mul_(scale)
        mc.mul_(opt.b1).add_(gc, alpha=1 - opt.b1)
        vc.mul_(opt.b2).addcmul_(gc, gc, value=1 - opt.b2)
        step = (mc / c1).div_((vc / c2).sqrt_().add_(opt.eps))
        step.add_(pc if decay_mask is None else pc * decay_mask[sl],
                  alpha=opt.weight_decay)
        pc.sub_(step, alpha=lr)


def _clip_scale(opt: AdamWConfig, gnorm):
    return torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

@register_impl("train_step", "lane_zero1", auto_ok=False)
def _build_zero1(run, opt, comm, single=False):
    """ZeRO-1: node-sharded flat gradients and moments through AdamW; the
    paper's trailing all-gather moves past the update (same bytes,
    applied to the new parameters).  Exact against the replicated AdamW:
    the true global norm is one scalar all-reduce over the node group of
    the shards' squares (disjoint over the node level, the same on every
    lane), and the decay follows ``decay_mask_flat``.  On a single batch
    axis it is the replicated step (``layout_kind``)."""
    if single:
        return get_impl("train_step", "native").fn(run, opt, comm, single)
    topo = comm.topo
    n = topo.n()
    vg = _microbatched(_value_and_grad(_make_loss(run, comm)),
                       run.microbatch, _accum_dtype(run))
    masks = {}

    def decay_mask(params, K):
        """This process's shard of the bool decay mask, built once."""
        dev = _tree.leaves(params)[0].device
        if (dev, K) not in masks:
            masks[dev, K] = zero1_param_shard(
                decay_mask_flat(params, K * n, dtype=torch.bool), topo, K)
        return masks[dev, K]

    def step(params, opt_state, tokens, labels, extra=None):
        loss, grads = vg(params, tokens, labels, extra)
        K = resolve_num_buckets(sum(p.numel() for p in _tree.leaves(params)),
                                n, run.gradsync_buckets)
        with torch.no_grad():
            with obs.span("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                g, _ = comm.grad_sync(grads, strategy="lane_zero1",
                                      num_buckets=K)
                del grads
                gsq = _sq_sum(g).reshape(1)
                dist.all_reduce(gsq, group=topo.node_group)
            with obs.span("train_step/optimizer"):
                pflat, pspec = _flatten_bucket(params, pad_to=K * n)
                mine = zero1_param_shard(pflat, topo, K)
                opt_state["count"] += 1
                _adamw_flat(opt, g, opt_state["m"], opt_state["v"], mine,
                            opt_state["count"],
                            scale=_clip_scale(opt, gsq[0].sqrt()),
                            decay_mask=decay_mask(params, K))
                del g
                zero1_unshard(mine, topo, K, out=pflat)
                _unflatten_bucket(pflat, pspec)
        return loss, params, opt_state
    step.full_params = lambda params: params
    return step


def zero1_opt_init(params, n: int, num_buckets: int = 0) -> dict:
    """The flat sharded f32 AdamW state of ``lane_zero1``: its size follows
    the bucketed padding (K·n), so pass the step's
    ``run.gradsync_buckets``."""
    total = sum(p.numel() for p in _tree.leaves(params))
    K = resolve_num_buckets(total, n, num_buckets)
    sz = -(-total // (K * n)) * K
    dev = _tree.leaves(params)[0].device
    return {"m": torch.zeros(sz, dtype=torch.float32, device=dev),
            "v": torch.zeros(sz, dtype=torch.float32, device=dev),
            "count": 0}


# ---------------------------------------------------------------------------
# ZeRO-3
# ---------------------------------------------------------------------------
#
# The family's layer stack is flattened per layer into an (L, D) f32
# master, padded to D_pad = B·n·N·s, and each process keeps its (L, B·s)
# stripe of the zero3_param_shard layout; everything but the stack and
# the replicated keys (embed, final_norm, ...) is the "extras"
# pseudo-layer, one more (B_e·s_e,) stripe.  The layouts derive from the
# ModelConfig alone (the meta-device template), so the state and the step
# agree on them.

def zero3_stack_layouts(cfg: ModelConfig, ep: bool = False) -> dict:
    """``{"blocks": StackLayout, "extras": StackLayout}`` of the family's
    sharded stacks, from the parameter template (no weights).  ``ep=True``
    (expert parallelism) keeps the MoE expert FFN leaves out of the
    blocks layout: they live in the never-gathered local experts."""
    stack, extras, _ = split_params(block_stack_spec(cfg),
                                    init_model(cfg, device="meta"))
    if ep:
        stack, _ = split_expert_stack(stack)
    return {"blocks": stack_layout(stack, stacked=True),
            "extras": stack_layout(extras, stacked=False)}


def _expert_rows(experts) -> list:
    """(L, E', ...) expert leaves -> one dict of row views per layer."""
    L = next(iter(experts.values())).shape[0]
    return [{k: t[i] for k, t in experts.items()} for i in range(L)]


def _stripe_len(layout, n: int, N: int, B: int) -> int:
    """B·s: the elements of one row a process keeps."""
    p = max(n * N, 1)
    D = layout.row_elems
    return (D + (-D) % (B * p)) // p


def zero3_opt_init(cfg: ModelConfig, params, n: int, N: int,
                   fsdp_prefetch: int = 0, *, ep: bool = False,
                   device="cuda") -> dict:
    """The split AdamW state of ``lane_zero3``: flat f32 moments of this
    process's stripes of the layer stack ((L, B·s)) and of the extras,
    and an ordinary AdamW tree for the family's replicated keys (empty
    but for the hybrid's shared attention block).  B resolves as the
    step's does: pass the same ``fsdp_prefetch``.  ``ep=True`` adds
    ``"experts"``: AdamW moments shaped like ``params["experts"]``, this
    process's (L, E/p, ...) experts."""
    dev = resolve_device(device)
    lays = zero3_stack_layouts(cfg, ep=ep)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, fsdp_prefetch)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        fsdp_prefetch)
    flat = lambda *shape: {
        "m": torch.zeros(shape, dtype=torch.float32, device=dev),
        "v": torch.zeros(shape, dtype=torch.float32, device=dev),
        "count": 0}
    _, _, repl = split_params(block_stack_spec(cfg), params)
    out = {"rest": adamw_init(repl),
           "blocks": flat(lay_b.length, _stripe_len(lay_b, n, N, Bb)),
           "extras": flat(_stripe_len(lay_e, n, N, Be))}
    if ep:
        out["experts"] = adamw_init(params["experts"])
    return out


@register_impl("train_step", "lane_zero3", auto_ok=False)
def _build_zero3(run, opt, comm, single=False):
    """ZeRO-3/FSDP: the layer stack stays sharded 1/p and is gathered
    LAYER BY LAYER inside the forward (``scan_stack`` over a
    ``ShardedStack``: the pipelined AG(lane)→AG(node) of
    ``comm.prefetch_allgather``, one layer ahead unless
    ``fsdp_prefetch=-1``; ``fsdp_regather`` gathers again in the
    backward); the extras gather once a step and their gradient comes
    back through the same transpose, applied once to the (microbatch-
    summed) cotangent cast to the leaves' dtypes.  The gathers'
    transposes reduce-scatter the gradients summed over the replicas, so
    only the mean is left; the replicated leftovers (the hybrid's shared
    block) sync through the bucketed lane path.  AdamW clips by the true
    global norm: one scalar all-reduce of the stripes' squares (disjoint
    over both levels) plus the replicated leftovers' norm."""
    if single or comm is None:
        raise ValueError(
            "lane_zero3 needs distinct lane and node batch axes (a "
            "multi-pod mesh); use native or lane_zero1 on single-"
            "batch-axis meshes (got batch axes ('data',))")
    cfg, topo = run.model, comm.topo
    n, N = topo.sizes()
    p = topo.p()
    ep_on, tp_comm = run.expert_parallel, _model_comm(run, comm)
    lays = zero3_stack_layouts(cfg, ep=ep_on)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, run.fsdp_prefetch)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        run.fsdp_prefetch)
    blocking = run.fsdp_prefetch == -1
    if blocking and run.fsdp_regather:
        raise ValueError(
            "fsdp_prefetch=-1 (the blocking negative control) and "
            "fsdp_regather are mutually exclusive: the re-gather scan "
            "would silently replace the blocking lowering the control "
            "is supposed to measure")
    gather_b = RowGather(comm, lay_b, Bb)
    gather_e = RowGather(comm, lay_e, Be)
    lf = _make_loss(run, comm, tp_comm)

    def lf3(diff, tokens, labels, extra):
        params = {**diff["repl"], **diff["extras"]}
        params["blocks"] = ShardedStack(diff["blocks"], gather_b,
                                        prefetch=not blocking,
                                        regather=run.fsdp_regather)
        if ep_on:
            params["ep_experts"] = diff["experts"]
        return lf(params, tokens, labels, extra)

    vg = _microbatched(_value_and_grad(lf3), run.microbatch,
                       _accum_dtype(run))
    masks = {}

    def decay_masks(dev):
        if dev not in masks:
            masks[dev] = [zero3_param_shard(
                lay.decay_mask(_stripe_len(lay, n, N, B) * p,
                               dtype=torch.bool, device=dev), topo, B)
                for lay, B in ((lay_b, Bb), (lay_e, Be))]
        return masks[dev]

    tp_idx = {}

    def tp_index(dev):
        """Where this process's stripe of a stack row holds TP weights."""
        if dev not in tp_idx:
            row = torch.zeros(_stripe_len(lay_b, n, N, Bb) * p,
                              dtype=torch.bool)
            m = _tp_row_mask(lay_b)
            row[:m.numel()] = m
            tp_idx[dev] = zero3_param_shard(row, topo, Bb).nonzero()[:, 0] \
                .to(dev)
        return tp_idx[dev]

    def step(params, opt_state, tokens, labels, extra=None):
        master_b, shard_e = params["blocks"], params["extras"]
        repl = {k: v for k, v in params.items()
                if k not in ("blocks", "extras", "experts")}
        rows = [master_b[i].detach().requires_grad_(True)
                for i in range(lay_b.length)]
        with torch.no_grad():
            ext_leaves = gather_e.detached(shard_e)
        ext = lay_e.tree_of([t.requires_grad_(True) for t in ext_leaves])
        diff = {"repl": repl, "blocks": rows, "extras": ext}
        if ep_on:
            # this process's f32 experts, never gathered: layer rows that
            # the stack body casts to the model's dtype
            diff["experts"] = [{k: t.detach().requires_grad_(True)
                                for k, t in lp.items()}
                               for lp in _expert_rows(params["experts"])]
        loss, g = vg(diff, tokens, labels, extra)
        with torch.no_grad():
            with obs.span("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                g_e = gather_e.transpose(
                    [a.to(t.dtype) for a, t in
                     zip(_tree.leaves(g["extras"]), ext_leaves)],
                    shard_e.numel()).div_(p)
                # the gathers' transposes reduce-scattered the stripes'
                # gradients summed over the replicas; the experts' come
                # whole to their owner through the routing's transpose
                g_b = [t.div_(p) for t in g["blocks"]]
                g_x = [{k: t.div_(p) for k, t in lp.items()}
                       for lp in g.get("experts", [])]
                g_repl = g["repl"]
                have_repl = bool(_tree.leaves(g_repl))
                if tp_comm is not None:
                    # each model rank's stripe holds the zero-padded column
                    # blocks of the TP weights: one masked sum over the
                    # model group assembles them (adding zeros), the other
                    # elements are the same on every model rank
                    idx = tp_index(master_b.device)
                    for gi in g_b:
                        sel = gi[idx]
                        dist.all_reduce(sel, group=tp_comm.topo.group)
                        gi[idx] = sel
                    if have_repl:
                        _tp_assemble_tree(g_repl, tp_comm)
                if have_repl:
                    comm.grad_sync(g_repl, strategy="lane")
                # the stripes and the E/p experts are disjoint over the
                # processes: one scalar all-reduce totals their squares
                gsq = (sum(_sq_sum(t) for t in g_b) + _sq_sum(g_e)
                       + sum(_sq_sum(t.reshape(-1)) for lp in g_x
                             for t in lp.values())).reshape(1)
                dist.all_reduce(gsq, group=topo.group)
                gsq = gsq[0]
                if have_repl:
                    gsq = gsq + global_norm(g_repl) ** 2
                gnorm = gsq.sqrt()
            with obs.span("train_step/optimizer"):
                scale = _clip_scale(opt, gnorm)
                if have_repl:
                    adamw_update(opt, g_repl, opt_state["rest"], repl,
                                 grad_norm=gnorm)
                else:       # repro's update of an empty tree counts too
                    opt_state["rest"]["count"] += 1
                mask_b, mask_e = decay_masks(master_b.device)
                ob, oe = opt_state["blocks"], opt_state["extras"]
                ob["count"] += 1
                oe["count"] += 1
                for i, gi in enumerate(g_b):
                    _adamw_flat(opt, gi, ob["m"][i], ob["v"][i], master_b[i],
                                ob["count"], scale=scale, decay_mask=mask_b)
                _adamw_flat(opt, g_e, oe["m"], oe["v"], shard_e, oe["count"],
                            scale=scale, decay_mask=mask_e)
                if ep_on:
                    # the tree AdamW over the experts' layer rows, in
                    # place (every expert leaf decays, as in repro)
                    ox = opt_state["experts"]
                    st = {"m": _expert_rows(ox["m"]),
                          "v": _expert_rows(ox["v"]), "count": ox["count"]}
                    adamw_update(opt, g_x, st, _expert_rows(params["experts"]),
                                 grad_norm=gnorm)
                    ox["count"] = st["count"]
        return loss, params, opt_state

    def full_params(params):
        """The whole parameter tree, gathered (no autograd, not counted):
        under EP the experts of every process are gathered in global-rank
        order and put back in each layer's ``moe``."""
        with torch.no_grad():
            gather = lambda lay, row, B: lay.unflatten_row(
                comm.prefetch_allgather(row, num_blocks=B))
            tree = gather(lay_e, params["extras"], Be)
            tree.update({k: v for k, v in params.items()
                         if k not in ("blocks", "extras", "experts")})
            tree["blocks"] = [gather(lay_b, row, Bb)
                              for row in params["blocks"]]
            if ep_on:
                dt = getattr(torch, cfg.dtype)
                whole = {k: _allgather_experts(t, topo).to(dt)
                         for k, t in params["experts"].items()}
                for i, lp in enumerate(tree["blocks"]):
                    lp["moe"].update({k: t[i] for k, t in whole.items()})
        return tree

    step.full_params = full_params
    step.gathers = (gather_b, gather_e)
    return step


def _allgather_experts(t, topo):
    """This process's (L, E/p, ...) expert leaf -> the whole (L, E, ...),
    the blocks in global-rank order, on every process."""
    if topo.p() == 1:
        return t.clone()
    parts = C.native_allgather(t.transpose(0, 1).contiguous(), topo)
    return parts.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# the state a step trains from
# ---------------------------------------------------------------------------

def init_train_state(params, *, device="cuda"):
    """``(params, opt_state)`` to train from: the parameters on ``device``
    as leaves that require grad (sharing storage with ``params`` where they
    are already there, so the step's updates show in both), and the AdamW
    state (f32 m and v, count 0).  Raises for a CUDA device on a host
    without one."""
    dev = resolve_device(device)
    params = _tree.tree_map(
        lambda p: p.detach().to(dev).requires_grad_(True), params)
    return params, adamw_init(params)




# ---------------------------------------------------------------------------
# checkpoint layouts, and the state a step trains from in each
# ---------------------------------------------------------------------------

def zero1_checkpoint_layout(params, n: int, num_buckets: int = 0):
    """The checkpoint layout of ``lane_zero1``'s flat moments (the same K
    and padding as ``zero1_opt_init`` and the step)."""
    total = sum(math.prod(p.shape) for p in _tree.leaves(params))
    K = resolve_num_buckets(total, n, num_buckets)
    return Zero1CheckpointLayout(total, K, n)


def zero3_checkpoint_layout(cfg: ModelConfig, n: int, N: int,
                            fsdp_prefetch: int = 0, ep: bool = False):
    """The checkpoint layout of ``lane_zero3``'s (L, B, p, s) masters, the
    layer stack and the extras pseudo-layer (the same B as
    ``shard_stack``, ``zero3_opt_init`` and the step).  ``ep=True``
    records the expert-parallel flavour: the blocks geometry leaves the
    expert FFN leaves out (they are checkpointed whole in their natural
    (L, E, ...) shapes, which are canonical)."""
    lays = zero3_stack_layouts(cfg, ep=ep)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, fsdp_prefetch)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        fsdp_prefetch)
    return Zero3CheckpointLayout(lay_b.length, lay_b.row_elems, Bb,
                                 max(n * N, 1),
                                 extra_elems=lay_e.row_elems,
                                 extra_blocks=Be, ep=ep)


def init_lane_train_state(run: RunConfig, params, comm=None, *,
                          single: bool = True, device="cuda"):
    """``(params, opt_state, checkpoint layout)`` in the layout of the step
    ``build_train_step(run, ..., comm, single=single)`` builds, from the
    whole parameter tree ``params`` (the port's layout, any device):

      replicated  ``init_train_state``; ``REPLICATED``;
      zero1       the parameters as there, the flat sharded moments
                  (``zero1_opt_init``); ``zero1_checkpoint_layout``;
      zero3       ``{"blocks": (L, B·s) f32, "extras": (B_e·s_e,) f32,
                  **replicated keys}``: this process's stripes of
                  ``shard_stack``'s masters, and ``zero3_opt_init``;
                  ``zero3_checkpoint_layout``, which must describe the
                  masters just made (it raises on drift, as ``repro``).
                  Expert-parallel, also ``"experts"``: this process's
                  (L, E/p, ...) f32 block of every expert leaf (experts
                  [r·E/p, (r+1)·E/p) on global rank r, the order
                  ``moe_block_ep`` routes by).

    The caller drops ``params`` afterwards: under zero3 the stripes
    replace it."""
    kind = layout_kind(run, single)
    if kind == "replicated":
        return (*init_train_state(params, device=device), REPLICATED)
    dev = resolve_device(device)
    topo = comm.topo
    n, N = topo.sizes()
    if kind == "zero1":
        params, _ = init_train_state(params, device=device)
        return (params, zero1_opt_init(params, n, run.gradsync_buckets),
                zero1_checkpoint_layout(params, n, run.gradsync_buckets))
    cfg = run.model
    ep = run.expert_parallel
    layout = zero3_checkpoint_layout(cfg, n, N, run.fsdp_prefetch, ep=ep)
    stack, extras, repl = split_params(block_stack_spec(cfg), params)
    idx = topo.node_rank() * N + topo.lane_rank()
    out, _ = init_train_state(repl, device=device)
    if ep:
        stack, experts = split_expert_stack(stack)
        out["experts"] = _local_experts(experts, topo, dev)
    got = {}
    for key, tree, stacked in (("blocks", stack, True),
                               ("extras", extras, False)):
        master, B = shard_stack(tree, n, N, run.fsdp_prefetch,
                                stacked=stacked)
        got[key] = (tuple(master.shape), B)
        mine = master[:, :, idx].reshape(master.shape[0], -1).to(dev)
        del master
        out[key] = mine if stacked else mine[0]
    if got != {"blocks": (layout.master_shape, layout.num_blocks),
               "extras": (layout.extra_master_shape, layout.extra_blocks)}:
        # both sides derive B and the padding from the stacks' element
        # counts; were they to disagree, the checkpoint would record the
        # wrong geometry
        raise ValueError(
            f"zero3 master layout drift: sharded stacks {got} vs "
            f"checkpoint layout {layout.master_shape}/"
            f"{layout.extra_master_shape} "
            f"(B={layout.num_blocks}/{layout.extra_blocks})")
    return out, zero3_opt_init(cfg, out, n, N, run.fsdp_prefetch, ep=ep,
                               device=dev), layout


def _local_experts(experts, topo, dev) -> dict:
    """One dict per layer of whole (E, ...) expert leaves -> this
    process's f32 (L, E/p, ...) block of each, on ``dev``."""
    p, r = topo.p(), topo.global_rank()
    out = {}
    for k in experts[0]:
        E = experts[0][k].shape[0]
        out[k] = torch.stack([
            lp[k].detach().narrow(0, r * (E // p), E // p).to(dev)
            for lp in experts]).float()
    return out


# ---------------------------------------------------------------------------
# the state on the host, in repro's layout (checkpoints)
# ---------------------------------------------------------------------------
#
# A checkpoint holds (params, opt_state) as repro's train driver has them:
# every layer stack one (L, ...) leaf per key path, ZeRO masters and
# moments in their host-global shapes (zero1 (n·K·s,), zero3 (L, B, p,
# s)), the step counts int32 scalars.  state_to_host assembles that tree
# on the topology's root (the stripes of every rank gathered to it over the
# communicator); host_to_state hands each rank its part of such a tree.
# The cross-layout path lifts a checkpoint's canonical leaves to the
# replicated form (state_to_replicated) and lays them out again for the
# current run (replicated_to_state): pure reshapes and transposes, and
# the cast of an f32 ZeRO master into a bf16 replicated parameter.

def _host(t):
    """An owned CPU copy of ``t`` (a meta tensor stays as it is)."""
    return t if t.is_meta else t.detach().to("cpu", copy=True)


def _stack_layers(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers]) for k in first}
    out = torch.empty((len(layers), *first.shape), dtype=first.dtype,
                      device="meta" if first.is_meta else "cpu")
    if not first.is_meta:
        for i, t in enumerate(layers):
            out[i].copy_(t.detach())
    return out


def _stacked(tree):
    """A tree of the port's layout (parameters, or moments mirroring them)
    in ``repro``'s: each list of layers under ``"blocks"`` becomes one
    (L, ...) leaf per key path.  Tensors become owned CPU copies (meta
    stays meta); other leaves (the step counts) are kept."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v) if k == _tree.STACK_KEY
                and isinstance(v, list) else _stacked(v)
                for k, v in tree.items()}
    return _host(tree) if isinstance(tree, torch.Tensor) else tree


def _unstacked(tree_r, like, fn):
    """``repro``-layout ``tree_r`` -> a tree of the port's layout shaped
    like ``like``, each leaf ``fn(repro leaf (its layer's row under a
    stack), like's leaf)``."""
    src = dict(_tree.flatten(tree_r))
    out = []
    for path, leaf in _tree.flatten(like):
        rpath, stack, layer = _tree.repro_path(path)
        a = src[rpath]
        out.append(fn(a if stack is None else a[layer], leaf))
    return _tree.unflatten(like, out)


def _as_torch(a):
    return a if isinstance(a, torch.Tensor) else to_torch(a)


def _cast(a, like):
    """A host leaf as a CPU tensor of ``like``'s dtype."""
    return _as_torch(a).to(dtype=like.dtype)


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _f32_like(tree):
    return _tree.tree_map(lambda t: _meta(t.shape), tree)


def _gather_to_root(t, topo):
    """Every process's ``t`` (the same shape everywhere) on the root of
    the communicator, as host copies by global rank; None elsewhere."""
    if topo.p() == 1:
        return [_host(t)]
    root = topo.rank_of(0)
    t = t.detach().contiguous()
    if dist.get_rank() != root:
        dist.gather(t, None, dst=root, group=topo.group)
        return None
    parts = [torch.empty_like(t) for _ in range(topo.p())]
    dist.gather(t, parts, dst=root, group=topo.group)
    return [_host(x) for x in parts]


def _master(t, topo, shape3):
    """This process's stripe ``t`` gathered into the host-global (L, B,
    p, s) master on the root (stripes in ``shard_stack``'s node-major
    order, process (node i, lane j) at i·N + j); None elsewhere."""
    parts = _gather_to_root(t, topo)
    if parts is None:
        return None
    if len(parts) == 1:                     # p = 1: a view, no copy
        return parts[0].view(shape3).unsqueeze(2)
    n, N = topo.sizes()
    return torch.stack([parts[j * n + i].view(shape3)
                        for i in range(n) for j in range(N)], dim=2)


def state_to_host(run: RunConfig, layout, params, opt_state, comm=None):
    """The checkpoint tree of a state in ``layout``: ``(params,
    opt_state)`` in ``repro``'s layout and host-global shapes, as owned
    CPU tensors (ints for the step counts), on the root of the topology
    (global rank 0, world rank ``comm.topo.rank_of(0)``, which after an
    elastic shrink need not be world rank 0), and None on every other
    process of it (each takes part in the gathers: every rank must call
    it)."""
    lead = comm is None or dist.get_rank() == comm.topo.rank_of(0)
    if layout.kind == "replicated":
        return (_stacked(params), _stacked(opt_state)) if lead else None
    topo = comm.topo
    if layout.kind == "zero1":
        n = topo.n()
        mv = {}
        for key in ("m", "v"):
            parts = _gather_to_root(opt_state[key], topo)
            mv[key] = None if parts is None else torch.cat(parts[:n])
        if not lead:
            return None
        return _stacked(params), {"count": opt_state["count"], **mv}
    L, B, _, s = layout.master_shape
    _, Be, _, se = layout.extra_master_shape
    shapes = {"blocks": (L, B, s), "extras": (1, Be, se)}
    masters = {(k, name): _master(t, topo, shapes[k])
               for k in ("blocks", "extras")
               for name, t in (("p", params[k]),
                               ("m", opt_state[k]["m"]),
                               ("v", opt_state[k]["v"]))}
    if layout.ep:
        # the experts of every process, whole along E in global-rank order
        ox = opt_state["experts"]
        experts = {name: {k: _cat_experts(_gather_to_root(t, topo))
                          for k, t in tree.items()}
                   for name, tree in (("p", params["experts"]),
                                      ("m", ox["m"]), ("v", ox["v"]))}
    if not lead:
        return None
    p_r = _stacked({k: v for k, v in params.items()
                    if k not in ("blocks", "extras", "experts")})
    o_r = {"rest": _stacked(opt_state["rest"])}
    for k in ("blocks", "extras"):
        p_r[k] = masters[k, "p"]
        o_r[k] = {"count": opt_state[k]["count"], "m": masters[k, "m"],
                  "v": masters[k, "v"]}
    if layout.ep:
        p_r["experts"] = experts["p"]
        o_r["experts"] = {"count": opt_state["experts"]["count"],
                          "m": experts["m"], "v": experts["v"]}
    return p_r, o_r


def _cat_experts(parts):
    """Every process's (L, E/p, ...) block by global rank -> (L, E, ...);
    None off the root."""
    return None if parts is None else torch.cat(parts, dim=1)


def host_to_state(run: RunConfig, layout, tree_r, comm=None, *,
                  device="cuda"):
    """This process's ``(params, opt_state)`` in ``layout`` on ``device``
    from a checkpoint tree of that layout (``state_to_host``'s form;
    numpy arrays or CPU tensors): the replicated leaves unstacked into
    the port's layer lists, zero1's node shard of the moments, zero3's
    stripe of every master."""
    cfg = run.model
    dev = resolve_device(device)
    tree_r = _tree.tree_map(lambda a: a if isinstance(a, int)
                            else host_array(a), tree_r)
    p_r, o_r = tree_r
    count = lambda a: int(np.asarray(a))
    put = lambda a, like: _cast(a, like).to(dev)
    params_t = init_model(cfg, device="meta")
    if layout.kind in ("replicated", "zero1"):
        params, _ = init_train_state(_unstacked(p_r, params_t, _cast),
                                     device=dev)
        if layout.kind == "replicated":
            f32 = _f32_like(params_t)
            return params, {"m": _unstacked(o_r["m"], f32, put),
                            "v": _unstacked(o_r["v"], f32, put),
                            "count": count(o_r["count"])}
        i = comm.topo.node_rank()
        shard = lambda a: to_torch(np.ascontiguousarray(
            a.reshape(layout.n, -1)[i])).to(dev)
        return params, {"m": shard(o_r["m"]), "v": shard(o_r["v"]),
                        "count": count(o_r["count"])}
    topo = comm.topo
    n, N = topo.sizes()
    idx = topo.node_rank() * N + topo.lane_rank()
    stripe = lambda a: to_torch(np.ascontiguousarray(
        a[:, :, idx])).reshape(a.shape[0], -1).to(dev)
    _, _, repl_t = split_params(block_stack_spec(cfg), params_t)
    repl = _unstacked({k: p_r[k] for k in repl_t}, repl_t, _cast)
    params, _ = init_train_state(repl, device=dev)
    params["blocks"] = stripe(p_r["blocks"])
    params["extras"] = stripe(p_r["extras"])[0]
    f32 = _f32_like(repl_t)
    ro = o_r["rest"]
    opt = {"rest": {"m": _unstacked(ro["m"], f32, put),
                    "v": _unstacked(ro["v"], f32, put),
                    "count": count(ro["count"])}}
    for k in ("blocks", "extras"):
        m, v = stripe(o_r[k]["m"]), stripe(o_r[k]["v"])
        if k == "extras":
            m, v = m[0], v[0]
        opt[k] = {"m": m, "v": v, "count": count(o_r[k]["count"])}
    if layout.ep:
        # this process's block of experts: [r·E/p, (r+1)·E/p)
        r, p = topo.global_rank(), topo.p()

        def mine(a):
            E = a.shape[1]
            return to_torch(np.ascontiguousarray(
                a[:, r * (E // p):(r + 1) * (E // p)])).float().to(dev)
        ox = o_r["experts"]
        params["experts"] = {k: mine(a) for k, a in p_r["experts"].items()}
        opt["experts"] = {"m": {k: mine(a) for k, a in ox["m"].items()},
                          "v": {k: mine(a) for k, a in ox["v"].items()},
                          "count": count(ox["count"])}
    return params, opt


def _state_template(cfg: ModelConfig, kind: str, *, flat=None, blocks=None,
                    extras=None, ep=False):
    """``(params, opt_state)`` of shapes in ``repro``'s layout (meta
    tensors; 0 for the step counts): ``replicated``; ``zero1`` with
    moments of ``flat`` elements; ``zero3`` with the stack and extras
    masters of shapes ``blocks`` and ``extras``, and with ``ep`` the whole
    f32 (L, E, ...) experts and their moments."""
    params_t = init_model(cfg, device="meta")
    adamw_t = lambda t: {"count": 0, "m": _stacked(_f32_like(t)),
                         "v": _stacked(_f32_like(t))}
    if kind == "replicated":
        return _stacked(params_t), adamw_t(params_t)
    if kind == "zero1":
        return _stacked(params_t), {"count": 0, "m": _meta((flat,)),
                                    "v": _meta((flat,))}
    if kind != "zero3":
        raise ValueError(f"unknown checkpoint layout kind {kind!r}")
    _, _, repl_t = split_params(block_stack_spec(cfg), params_t)
    p_t = _stacked(repl_t)
    o_t = {"rest": adamw_t(repl_t)}
    for k, shape in (("blocks", blocks), ("extras", extras)):
        p_t[k] = _meta(shape)
        o_t[k] = {"count": 0, "m": _meta(shape), "v": _meta(shape)}
    if ep:
        stack_t, _, _ = split_params(block_stack_spec(cfg), params_t)
        _, exp_t = split_expert_stack(stack_t)
        shapes = {k: (len(exp_t), *t.shape) for k, t in exp_t[0].items()}
        p_t["experts"] = {k: _meta(v) for k, v in shapes.items()}
        o_t["experts"] = {"count": 0,
                          "m": {k: _meta(v) for k, v in shapes.items()},
                          "v": {k: _meta(v) for k, v in shapes.items()}}
    return p_t, o_t


def _canonical_state_template(cfg: ModelConfig, entry: dict):
    """The template of the canonical leaves a checkpoint of layout
    ``entry`` (its manifest's) stores."""
    kind = (entry or {}).get("kind", "replicated")
    if kind == "zero3":
        if not entry.get("extra_elems"):
            raise ValueError(
                "zero3 checkpoint predates the extras pseudo-layer (no "
                "extra_elems in its layout entry); cross-layout restore "
                "needs the current master format")
        ep = bool(entry.get("ep"))
        lays = zero3_stack_layouts(cfg, ep=ep)
        return _state_template(
            cfg, kind,
            blocks=(lays["blocks"].length, lays["blocks"].row_elems),
            extras=(1, lays["extras"].row_elems), ep=ep)
    return _state_template(cfg, kind,
                           flat=int((entry or {}).get("total_elems", 0)))


def _layout_template(cfg: ModelConfig, layout):
    """The template of a checkpoint tree in ``layout`` (host-global)."""
    if layout.kind == "zero3":
        return _state_template(cfg, "zero3", blocks=layout.master_shape,
                               extras=layout.extra_master_shape,
                               ep=layout.ep)
    return _state_template(cfg, layout.kind,
                           flat=getattr(layout, "padded", None))


def state_to_replicated(cfg: ModelConfig, entry: dict, state):
    """A checkpoint's canonical ``(params, opt_state)`` of layout
    ``entry`` (numpy arrays or CPU tensors, ``repro``'s layout) -> the
    replicated form in the port's layout: (params, {"m", "v", "count"})
    as CPU tensors, the parameters in the dtypes stored (zero3: cast
    from the f32 masters to the model's), the moments f32."""
    kind = (entry or {}).get("kind", "replicated")
    p_r, o_r = state
    params_t = init_model(cfg, device="meta")
    f32 = _f32_like(params_t)
    count = lambda a: int(np.asarray(a))
    if kind == "replicated":
        return _unstacked(p_r, params_t, lambda a, _: _as_torch(a)), {
            "m": _unstacked(o_r["m"], f32, _cast),
            "v": _unstacked(o_r["v"], f32, _cast),
            "count": count(o_r["count"])}
    if kind == "zero1":
        shapes = [t.shape for t in _tree.leaves(params_t)]
        mk = lambda flat: _tree.unflatten(f32, [
            torch.from_numpy(np.ascontiguousarray(x)) for x in
            split_flat_order(host_array(flat), shapes)])
        return _unstacked(p_r, params_t, lambda a, _: _as_torch(a)), {
            "m": mk(o_r["m"]), "v": mk(o_r["v"]),
            "count": count(o_r["count"])}
    if kind != "zero3":
        raise ValueError(f"unknown lane state layout kind {kind!r}")
    ep = bool(entry.get("ep"))
    lays = zero3_stack_layouts(cfg, ep=ep)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    _, _, repl_t = split_params(block_stack_spec(cfg), params_t)
    row = lambda a: _as_torch(a).float().contiguous()
    dt_model = getattr(torch, cfg.dtype)

    def tree(repl_src, blocks, extras, experts, dtype=None):
        out = _unstacked(repl_src, _f32_like(repl_t) if dtype else repl_t,
                         _cast)
        out.update(lay_e.unflatten_row(row(extras[0]), dtype))
        out["blocks"] = [lay_b.unflatten_row(row(r), dtype) for r in blocks]
        if experts is not None:
            # the natural-shape experts back into each layer's moe (cast
            # to the model's dtype, as unflatten_row casts the stack)
            ex = {k: _as_torch(a) for k, a in experts.items()}
            for i, lp in enumerate(out["blocks"]):
                lp["moe"].update({k: a[i].to(dtype or dt_model)
                                  for k, a in ex.items()})
        return out
    px = p_r["experts"] if ep else None
    params = tree({k: p_r[k] for k in repl_t}, p_r["blocks"],
                  p_r["extras"], px)
    moments = {name: tree(o_r["rest"][name], o_r["blocks"][name],
                          o_r["extras"][name],
                          o_r["experts"][name] if ep else None,
                          torch.float32)
               for name in ("m", "v")}
    return params, {**moments, "count": count(o_r["blocks"]["count"])}


def replicated_to_state(cfg: ModelConfig, run: RunConfig, n: int, N: int,
                        params, opt_state, *, kind: str):
    """The replicated form (``state_to_replicated``'s) -> the checkpoint
    tree of layout ``kind`` for an (n, N) topology: ``state_to_host``'s
    form, with the values ``init_lane_train_state`` would lay out."""
    count = opt_state["count"]
    if kind == "replicated":
        # into the model's dtypes (an f32 ZeRO master into a bf16 run)
        params = _tree.tree_map(lambda v, t: v.to(t.dtype), params,
                                init_model(cfg, device="meta"))
        return _stacked(params), {"count": count,
                                  "m": _stacked(opt_state["m"]),
                                  "v": _stacked(opt_state["v"])}
    if kind == "zero1":
        layout = zero1_checkpoint_layout(params, n, run.gradsync_buckets)
        lay1 = lambda tree: layout.from_canonical(("m",), concat_flat_order(
            [host_array(t) for t in _tree.leaves(tree)]))
        return _stacked(params), {"count": count, "m": lay1(opt_state["m"]),
                                  "v": lay1(opt_state["v"])}
    if kind != "zero3":
        raise ValueError(f"unknown lane state layout kind {kind!r}")
    spec = block_stack_spec(cfg)
    ep = run.expert_parallel

    def masters(tree):
        stack, extras, repl = split_params(spec, tree)
        experts = None
        if ep:
            stack, ex = split_expert_stack(stack)
            experts = {k: torch.stack([lp[k] for lp in ex]).float()
                       for k in ex[0]}
        return (shard_stack(stack, n, N, run.fsdp_prefetch)[0],
                shard_stack(extras, n, N, run.fsdp_prefetch,
                            stacked=False)[0], _stacked(repl), experts)
    pb, pe, p3, px = masters(params)
    p3.update(blocks=pb, extras=pe)
    (mb, me, mr, mx), (vb, ve, vr, vx) = masters(opt_state["m"]), \
        masters(opt_state["v"])
    o3 = {"rest": {"count": count, "m": mr, "v": vr},
          "blocks": {"count": count, "m": mb, "v": vb},
          "extras": {"count": count, "m": me, "v": ve}}
    if ep:
        p3["experts"] = px
        o3["experts"] = {"count": count, "m": mx, "v": vx}
    return p3, o3


def restore_lane_train_state(ckpt_dir: str, run: RunConfig, layout,
                             comm=None, *, step=None, device="cuda"):
    """Restore a checkpoint into this process's state of ``layout`` (the
    run's, from ``init_lane_train_state``), through the canonical
    replicated form when the checkpoint was written under another layout
    kind or topology (a ``lane_zero3`` checkpoint into a ``lane_zero1``
    or replicated run, and back; any number of ranks).  Returns
    ``((params, opt_state), step)``; every process reads the files.

    Leaves are crc-checked as they load.  With ``step=None`` a corrupt
    newest checkpoint falls back to the newest committed step that
    verifies; an explicit step raises ``CheckpointCorruptError``.
    Geometry ValueErrors always propagate."""
    candidates = [step] if step is not None \
        else list(reversed(committed_steps(ckpt_dir)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    last_err = None
    for cand in candidates:
        try:
            return _restore_lane_state_at(ckpt_dir, run, layout, comm, cand,
                                          device)
        except CheckpointCorruptError as e:
            last_err = e
            if step is not None:
                raise
            print(f"checkpoint step {cand} is corrupt ({e}); falling "
                  f"back to the previous committed step",
                  file=sys.stderr, flush=True)
    raise CheckpointCorruptError(
        f"no verifiable checkpoint in {ckpt_dir} "
        f"(tried steps {candidates})") from last_err


def _pair_canonical(template, man: dict, arrays: list, kind: str):
    """``template`` (a tree of meta tensors and ints) with a checkpoint's
    canonical leaves in its flat order, each read by the manifest's dtype
    as a CPU tensor after its shape is checked."""
    refs = _tree.leaves(template)
    if len(refs) != len(arrays):
        raise ValueError(
            f"checkpoint holds {len(arrays)} leaves but a {kind!r} state "
            f"of this model has {len(refs)} (different model?)")
    leaves = []
    for i, (ref, arr, entry) in enumerate(zip(refs, arrays, man["leaves"])):
        if tuple(getattr(ref, "shape", ())) != tuple(arr.shape):
            raise ValueError(
                f"cross-layout restore: canonical leaf {i} has shape "
                f"{tuple(arr.shape)} but a {kind!r} state of this model "
                f"stores {tuple(getattr(ref, 'shape', ()))} (different "
                f"model?)")
        leaves.append(to_torch(arr, entry["dtype"]))
    return _tree.unflatten(template, leaves)


def load_canonical_state(ckpt_dir: str, cfg: ModelConfig, step=None):
    """``(manifest, the canonical (params, opt_state) tree, step)`` of
    one checkpoint, its leaves paired with the template of its layout
    (shapes checked) and read by the manifest's dtypes."""
    man, arrays, got = load_canonical(ckpt_dir, step)
    entry = man.get("layout") or {}
    return man, _pair_canonical(_canonical_state_template(cfg, entry), man,
                                arrays, entry.get("kind", "replicated")), got


def load_canonical_params(ckpt_dir: str, cfg: ModelConfig, step=None):
    """``(params, step)``: the replicated parameters of one checkpoint in
    the port's layout, as CPU tensors in the dtypes stored, from a whole
    training state of any layout (lifted by ``state_to_replicated``, the
    optimizer state dropped) or from a replicated tree of parameters
    alone, as ``repro``'s ``load_serve_params`` accepts both.  The
    leaves are read once."""
    man, arrays, got = load_canonical(ckpt_dir, step)
    entry = man.get("layout") or {}
    kind = entry.get("kind", "replicated")
    params_t = init_model(cfg, device="meta")
    state_t = _canonical_state_template(cfg, entry)
    stacked_t = _stacked(params_t)
    n_state = len(_tree.leaves(state_t))
    n_params = len(_tree.leaves(stacked_t))
    if len(arrays) == n_state:
        state = _pair_canonical(state_t, man, arrays, kind)
        return state_to_replicated(cfg, entry, state)[0], got
    if len(arrays) == n_params and kind == "replicated":
        tree_r = _pair_canonical(stacked_t, man, arrays, kind)
        return _unstacked(tree_r, params_t, lambda a, _: a), got
    raise ValueError(
        f"checkpoint at {ckpt_dir} holds {len(arrays)} leaves; a {kind!r} "
        f"state of this model has {n_state} (or {n_params} params-only) "
        f"(different model?)")


def _restore_lane_state_at(ckpt_dir, run, layout, comm, step, device):
    cfg = run.model
    # decide from the manifest alone: the usual same-kind resume reads
    # the masters once
    man, got = peek_manifest(ckpt_dir, step)
    entry = man.get("layout") or {}
    # the ep flag changes the zero3 master geometry (the experts leave the
    # flat stack): a change of it goes through the canonical form
    if entry.get("kind", "replicated") == layout.kind \
            and bool(entry.get("ep")) == bool(getattr(layout, "ep", False)):
        tree, got = restore_checkpoint(ckpt_dir, _layout_template(cfg, layout),
                                       step=got, layout=layout)
    else:
        man, src, got = load_canonical_state(ckpt_dir, cfg, got)
        n, N = comm.topo.sizes() if comm is not None else (1, 1)
        tree = replicated_to_state(cfg, run, n, N,
                                   *state_to_replicated(cfg, entry, src),
                                   kind=layout.kind)
    return host_to_state(run, layout, tree, comm, device=device), got
