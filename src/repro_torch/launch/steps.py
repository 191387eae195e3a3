"""The replicated train step, on one process or across ranks.

Counterpart of ``repro.launch.steps``' replicated ``train_step`` flavor
(``_register_replicated``), with its ``_make_loss``, ``_accum_dtype`` and
``_microbatched``: value and gradient of ``loss_fn`` (optionally over
microbatches), the gradient sync, then AdamW.  Across ranks the step is
given a ``LaneComm`` over the world's node/lane topology: it averages
the loss over the communicator and calls ``comm.grad_sync(grads,
strategy=eff)`` between the backward and AdamW, with ``eff = "native"``
on a single batch axis, as ``repro`` does.  On one process (no comm) both
are the identity and the step has neither.

Forward, backward, gradient sync and optimizer run inside
``torch.profiler`` annotations (``train_step/forward``,
``train_step/backward``, ``train_step/grad_sync``,
``train_step/optimizer``), which cost a few microseconds a step when no
profiler is on.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.comm import LaneComm
from repro_torch.configs.base import RunConfig
from repro_torch.models import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


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


def build_train_step(run: RunConfig, opt: AdamWConfig,
                     comm: "LaneComm | None" = None, *, single: bool = True):
    """``step(params, opt_state, tokens, labels, extra=None) -> (loss,
    params, opt_state)``; ``params`` and ``opt_state`` come from
    ``init_train_state`` and are updated in place.  ``extra``: the vlm
    patches or audio frames of the batch, or None.

    ``comm``: None on one process; across ranks, the ``LaneComm`` of the
    world's topology (``launch.mesh.make_lane_topology``), each rank
    passing its own rows of the global batch.  ``single``: the topology
    has one batch axis, where every strategy degrades to ``"native"``."""
    vg = _microbatched(_value_and_grad(_make_loss(run)), run.microbatch,
                       _accum_dtype(run))
    eff = "native" if single else run.gradsync

    def step(params, opt_state, tokens, labels, extra=None):
        loss, grads = vg(params, tokens, labels, extra)
        if comm is not None:
            with record_function("train_step/grad_sync"):
                loss = comm.allreduce(loss.reshape(1), strategy="native"
                                      )[0] / comm.topo.p()
                grads = comm.grad_sync(grads, strategy=eff)
        with record_function("train_step/optimizer"):
            params, opt_state = adamw_update(opt, grads, opt_state, params)
        return loss, params, opt_state
    return step



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
