"""The train steps, on one process or across ranks: the replicated step
and the ZeRO steps.

Counterpart of ``repro.launch.steps``' ``train_step`` flavors, with its
``_make_loss``, ``_accum_dtype``, ``_microbatched`` and ``_adamw_flat``.
The flavor follows the parameter layout ``run.gradsync`` registers
(``comm.layout``):

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

Unlike ``repro``, which is functional, every step updates its state in
place: at llama3.2-3b each functional copy is 12.85 GB of f32.  The
flat AdamW runs over chunks, so its temporaries stay small.

Forward, backward, gradient sync and optimizer run inside
``torch.profiler`` annotations (``train_step/forward``,
``train_step/backward``, ``train_step/grad_sync``,
``train_step/optimizer``), which cost a few microseconds a step when no
profiler is on.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.comm import LaneComm
from repro_torch.comm.layout import param_layout_kind
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import init_model, make_train_step
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


def _make_loss(run: RunConfig):
    """``lf(params, tokens, labels, extra) -> loss``."""
    return make_train_step(run.model, remat=run.remat)


def _value_and_grad(lf):
    """``vg(params, tokens, labels, extra) -> (loss, grads)``: ``grads``
    mirrors ``params``, each leaf in its parameter's dtype (zero where the
    loss does not reach it), as ``jax.value_and_grad`` gives them."""
    def vg(params, tokens, labels, extra):
        leaves = _tree.leaves(params)
        with record_function("train_step/forward"):
            loss = lf(params, tokens, labels, extra)
        with record_function("train_step/backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
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

    ``comm``: None on one process; across ranks, the ``LaneComm`` of the
    world's topology (``launch.mesh.make_lane_topology``), each rank
    passing its own rows of the global batch.  ``single``: the topology
    has one batch axis, where the replicated strategies degrade to
    ``"native"``, ``lane_zero1`` to the replicated step, and
    ``lane_zero3`` raises."""
    kind = layout_kind(run, single)
    if kind == "zero3":
        return _build_zero3(run, opt, comm, single)
    if kind == "zero1":
        return _build_zero1(run, opt, comm)
    return _build_replicated(run, opt, comm, single)


def _mean_loss(comm: LaneComm, loss):
    return comm.allreduce(loss.reshape(1), strategy="native")[0] \
        / comm.topo.p()


def _build_replicated(run, opt, comm, single):
    vg = _microbatched(_value_and_grad(_make_loss(run)), run.microbatch,
                       _accum_dtype(run))
    eff = "native" if single else run.gradsync

    def step(params, opt_state, tokens, labels, extra=None):
        loss, grads = vg(params, tokens, labels, extra)
        if comm is not None:
            with record_function("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                grads = comm.grad_sync(grads, strategy=eff)
        with record_function("train_step/optimizer"):
            params, opt_state = adamw_update(opt, grads, opt_state, params)
        return loss, params, opt_state
    step.full_params = lambda params: params
    return step


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

def _build_zero1(run, opt, comm):
    """ZeRO-1: node-sharded flat gradients and moments through AdamW; the
    paper's trailing all-gather moves past the update (same bytes,
    applied to the new parameters).  Exact against the replicated AdamW:
    the true global norm is one scalar all-reduce over the node group of
    the shards' squares (disjoint over the node level, the same on every
    lane), and the decay follows ``decay_mask_flat``."""
    topo = comm.topo
    n = topo.n()
    vg = _microbatched(_value_and_grad(_make_loss(run)), run.microbatch,
                       _accum_dtype(run))
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
            with record_function("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                g, _ = comm.grad_sync(grads, strategy="lane_zero1",
                                      num_buckets=K)
                del grads
                gsq = _sq_sum(g).reshape(1)
                dist.all_reduce(gsq, group=topo.node_group)
            with record_function("train_step/optimizer"):
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

def zero3_stack_layouts(cfg: ModelConfig) -> dict:
    """``{"blocks": StackLayout, "extras": StackLayout}`` of the family's
    sharded stacks, from the parameter template (no weights)."""
    stack, extras, _ = split_params(block_stack_spec(cfg),
                                    init_model(cfg, device="meta"))
    return {"blocks": stack_layout(stack, stacked=True),
            "extras": stack_layout(extras, stacked=False)}


def _stripe_len(layout, n: int, N: int, B: int) -> int:
    """B·s: the elements of one row a process keeps."""
    p = max(n * N, 1)
    D = layout.row_elems
    return (D + (-D) % (B * p)) // p


def zero3_opt_init(cfg: ModelConfig, params, n: int, N: int,
                   fsdp_prefetch: int = 0, *, device="cuda") -> dict:
    """The split AdamW state of ``lane_zero3``: flat f32 moments of this
    process's stripes of the layer stack ((L, B·s)) and of the extras,
    and an ordinary AdamW tree for the family's replicated keys (empty
    but for the hybrid's shared attention block).  B resolves as the
    step's does: pass the same ``fsdp_prefetch``."""
    dev = resolve_device(device)
    lays = zero3_stack_layouts(cfg)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, fsdp_prefetch)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        fsdp_prefetch)
    flat = lambda *shape: {
        "m": torch.zeros(shape, dtype=torch.float32, device=dev),
        "v": torch.zeros(shape, dtype=torch.float32, device=dev),
        "count": 0}
    _, _, repl = split_params(block_stack_spec(cfg), params)
    return {"rest": adamw_init(repl),
            "blocks": flat(lay_b.length, _stripe_len(lay_b, n, N, Bb)),
            "extras": flat(_stripe_len(lay_e, n, N, Be))}


def _build_zero3(run, opt, comm, single):
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
    lays = zero3_stack_layouts(cfg)
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
    lf = _make_loss(run)

    def lf3(diff, tokens, labels, extra):
        params = {**diff["repl"], **diff["extras"]}
        params["blocks"] = ShardedStack(diff["blocks"], gather_b,
                                        prefetch=not blocking,
                                        regather=run.fsdp_regather)
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

    def step(params, opt_state, tokens, labels, extra=None):
        master_b, shard_e = params["blocks"], params["extras"]
        repl = {k: v for k, v in params.items()
                if k not in ("blocks", "extras")}
        rows = [master_b[i].detach().requires_grad_(True)
                for i in range(lay_b.length)]
        with torch.no_grad():
            ext_leaves = gather_e.detached(shard_e)
        ext = lay_e.tree_of([t.requires_grad_(True) for t in ext_leaves])
        loss, g = vg({"repl": repl, "blocks": rows, "extras": ext}, tokens,
                     labels, extra)
        with torch.no_grad():
            with record_function("train_step/grad_sync"):
                loss = _mean_loss(comm, loss)
                g_e = gather_e.transpose(
                    [a.to(t.dtype) for a, t in
                     zip(_tree.leaves(g["extras"]), ext_leaves)],
                    shard_e.numel()).div_(p)
                g_b = [t.div_(p) for t in g["blocks"]]
                g_repl = g["repl"]
                have_repl = bool(_tree.leaves(g_repl))
                if have_repl:
                    comm.grad_sync(g_repl, strategy="lane")
                gsq = (sum(_sq_sum(t) for t in g_b) + _sq_sum(g_e)
                       ).reshape(1)
                dist.all_reduce(gsq, group=topo.group)
                gsq = gsq[0]
                if have_repl:
                    gsq = gsq + global_norm(g_repl) ** 2
                gnorm = gsq.sqrt()
            with record_function("train_step/optimizer"):
                scale = _clip_scale(opt, gnorm)
                if have_repl:
                    adamw_update(opt, g_repl, opt_state["rest"], repl,
                                 grad_norm=gnorm)
                mask_b, mask_e = decay_masks(master_b.device)
                ob, oe = opt_state["blocks"], opt_state["extras"]
                ob["count"] += 1
                oe["count"] += 1
                for i, gi in enumerate(g_b):
                    _adamw_flat(opt, gi, ob["m"][i], ob["v"][i], master_b[i],
                                ob["count"], scale=scale, decay_mask=mask_b)
                _adamw_flat(opt, g_e, oe["m"], oe["v"], shard_e, oe["count"],
                            scale=scale, decay_mask=mask_e)
        return loss, params, opt_state

    def full_params(params):
        """The whole parameter tree, gathered (no autograd, not counted)."""
        with torch.no_grad():
            gather = lambda lay, row, B: lay.unflatten_row(
                comm.prefetch_allgather(row, num_blocks=B))
            tree = gather(lay_e, params["extras"], Be)
            tree.update({k: v for k, v in params.items()
                         if k not in ("blocks", "extras")})
            tree["blocks"] = [gather(lay_b, row, Bb)
                              for row in params["blocks"]]
        return tree

    step.full_params = full_params
    step.gathers = (gather_b, gather_e)
    return step


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


def init_lane_train_state(run: RunConfig, params, comm=None, *,
                          single: bool = True, device="cuda"):
    """``(params, opt_state)`` in the layout of the step
    ``build_train_step(run, ..., comm, single=single)`` builds, from the
    whole parameter tree ``params`` (the port's layout, any device):

      replicated  ``init_train_state``;
      zero1       the parameters as there, the flat sharded moments
                  (``zero1_opt_init``);
      zero3       ``{"blocks": (L, B·s) f32, "extras": (B_e·s_e,) f32,
                  **replicated keys}``: this process's stripes of
                  ``shard_stack``'s masters, and ``zero3_opt_init``.

    The caller drops ``params`` afterwards: under zero3 the stripes
    replace it."""
    kind = layout_kind(run, single)
    if kind == "replicated":
        return init_train_state(params, device=device)
    dev = resolve_device(device)
    topo = comm.topo
    n, N = topo.sizes()
    if kind == "zero1":
        params, _ = init_train_state(params, device=device)
        return params, zero1_opt_init(params, n, run.gradsync_buckets)
    cfg = run.model
    stack, extras, repl = split_params(block_stack_spec(cfg), params)
    idx = topo.node_rank() * N + topo.lane_rank()
    out, _ = init_train_state(repl, device=device)
    for key, tree, stacked in (("blocks", stack, True),
                               ("extras", extras, False)):
        master, _ = shard_stack(tree, n, N, run.fsdp_prefetch,
                                stacked=stacked)
        mine = master[:, :, idx].reshape(master.shape[0], -1).to(dev)
        del master
        out[key] = mine if stacked else mine[0]
    return out, zero3_opt_init(cfg, out, n, N, run.fsdp_prefetch,
                               device=dev)
