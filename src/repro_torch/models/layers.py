"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

Counterpart of ``repro.models.layers``.  Parameters are plain dicts of
tensors and every ``apply`` function is stateless, as in ``repro``; the
weights keep ``repro``'s (in, out) layout so a block computes ``x @ w``.
Initialisation draws from an explicit ``torch.Generator`` with
``repro``'s distribution (truncated normal on [-2, 2], times 0.02, or
times 1.0 for the token table); the bits differ from ``jax.random``, so
tests that compare the two packages start both from ``repro``'s weights
(``repro_torch.bridge``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(shape, dtype, *, generator, device, scale: float = 0.02):
    """``scale`` × truncated normal on [-2, 2], drawn in f32, cast to
    ``dtype``.  On the meta device only the shape and type are made (the
    bridge's parameter template)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm / LayerNorm (computed in f32, cast back)
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x, eps: float):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x, eps: float):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def apply_norm(p: dict, x, eps: float):
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int → (..., head_dim/2) angles, f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions.float()[..., None] * freqs


def apply_rope(x, positions, theta: float):
    """x: (B, T, H, D) with D even; positions: (B, T) or (T,)."""
    ang = rope_angles(positions, x.shape[-1], theta)   # (B?, T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.ndim < x.ndim:                           # broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, *, generator, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, torch_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"w_up": dense_init((d, f), dt, **kw),
         "w_down": dense_init((f, d), dt, **kw)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((d, f), dt, **kw)
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(p: dict, x, cfg: ModelConfig):
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(cfg.act)(x @ p["w_gate"]) * h
    else:
        h = _act(cfg.act)(h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# tensor-parallel MLPs (over a model-axis LaneComm: n = 1, N = tp)
# ---------------------------------------------------------------------------

def _allgather_last(comm, x, strategy=None):
    """All-gather the LAST axis over ``comm`` in global-rank order (the
    feature axis moved to the front for the wire and back after; the
    global rank is the model rank on the model topology, so the
    concatenation follows the column slices)."""
    g = comm.allgather(x.movedim(-1, 0).contiguous(), strategy=strategy)
    return g.movedim(0, -1)


def _tp_cols(comm, w, width: int, axis: int = 1):
    """This model rank's ``width``-column block of ``w`` along ``axis``."""
    return w.narrow(axis, comm.topo.global_rank() * width, width)


def _tp_parts(act, comm, strategy, x, w_up, w_gate, w_down):
    """mlp_tp's forward: (its output, the gathered activation)."""
    tp = comm.topo.p()
    f, d = w_up.shape[1], w_down.shape[1]
    h = x @ _tp_cols(comm, w_up, f // tp)
    if w_gate is not None:
        h = _act(act)(x @ _tp_cols(comm, w_gate, f // tp)) * h
    else:
        h = _act(act)(h)
    a = _allgather_last(comm, h, strategy)               # (.., f) whole
    y = a @ _tp_cols(comm, w_down, d // tp)
    return _allgather_last(comm, y, strategy), a         # (.., d) whole


class _MlpTP(torch.autograd.Function):
    """mlp_tp with ``repro``'s custom backward (``_mlp_tp_bwd``): column
    blocks of the replicated backward, assembled by gathers.

    Each product below is a contiguous output block of the replicated
    backward's product with the same contraction, so each block is that
    slice of the replicated gradient; the weight gradients come back
    zero-padded to the whole weight (one sum over the model group
    assembles them, adding zeros), and the input's cotangent is gathered
    whole, so everything before the MLP sees the replicated cotangent.
    Plain autograd through the forward's all-gathers would hand each rank
    a tp-scaled partial cotangent instead."""

    @staticmethod
    def forward(ctx, x, w_up, w_gate, w_down, act, comm, strategy):
        y, a = _tp_parts(act, comm, strategy, x, w_up, w_gate, w_down)
        ctx.act, ctx.comm, ctx.strategy = act, comm, strategy
        ctx.save_for_backward(x, a, w_up, w_gate, w_down)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, a, w_up, w_gate, w_down = ctx.saved_tensors
        act, comm, strategy = ctx.act, ctx.comm, ctx.strategy
        tp = comm.topo.p()
        f, d = w_up.shape[1], w_down.shape[1]
        fl, dl = f // tp, d // tp
        r = comm.topo.global_rank()
        # the replicated dh = dy @ w_down.T: rows r·fl.. of w_down give
        # this rank's columns
        dh = dy @ w_down.narrow(0, r * fl, fl).T
        with torch.enable_grad():
            h1 = (x @ _tp_cols(comm, w_up, fl)).detach().requires_grad_()
            if w_gate is None:
                dh1, = torch.autograd.grad(_act(act)(h1), h1, dh)
                dhg = None
            else:
                hg = (x @ _tp_cols(comm, w_gate, fl)).detach() \
                    .requires_grad_()
                dh1, dhg = torch.autograd.grad(_act(act)(hg) * h1,
                                               (h1, hg), dh)
        bt = x.reshape(-1, x.shape[-1])                  # (B·T, d)

        def wgrad(u, v, shape, col):
            """``u.T @ v`` as columns col.. of a zero gradient of
            ``shape``."""
            g = u.new_zeros(shape)
            g.narrow(1, col, v.shape[-1]).copy_(
                u.T @ v.reshape(-1, v.shape[-1]))
            return g

        dw_up = wgrad(bt, dh1, w_up.shape, r * fl)
        dw_gate = None if w_gate is None else \
            wgrad(bt, dhg, w_gate.shape, r * fl)
        dw_down = wgrad(a.reshape(-1, f), dy.narrow(-1, r * dl, dl),
                        w_down.shape, r * dl)
        # the whole f-cotangents (concatenations of exact slices), then
        # the d-column block of dx and a gather back to whole
        dh1 = _allgather_last(comm, dh1, strategy)
        dx = dh1 @ w_up.narrow(0, r * dl, dl).T
        if w_gate is not None:
            dhg = _allgather_last(comm, dhg, strategy)
            dx = dx + dhg @ w_gate.narrow(0, r * dl, dl).T
        dx = _allgather_last(comm, dx, strategy)
        return dx, dw_up, dw_gate, dw_down, None, None, None


def mlp_tp(p: dict, x, cfg: ModelConfig, *, comm, strategy=None):
    """Tensor-parallel MLP, equal to :func:`mlp` in its forward and in
    each rank's gradients.

    Every product is column-parallel: each model rank computes its f/tp
    (then d/tp) output columns and an all-gather over the model group
    puts the whole activation together (concatenation only), so each
    element comes from the replicated path's dot products.  The backward
    is :class:`_MlpTP`'s."""
    tp = comm.topo.p()
    f, d = cfg.d_ff, cfg.d_model
    if f % tp or d % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide d_ff={f} and "
            f"d_model={d}")
    return _MlpTP.apply(x, p["w_up"], p.get("w_gate"), p["w_down"],
                        cfg.act, comm, strategy)


def mlp_tp_reduce(p: dict, x, cfg: ModelConfig, *, comm, strategy=None):
    """Megatron-style TP MLP: column-parallel up/gate, ROW-parallel down,
    one all-reduce over the model group on the output.

    Half the activation traffic of :func:`mlp_tp` (no f-gather), but the
    partial products are summed across ranks, so it equals :func:`mlp`
    only to rounding.  A standalone function: no model path routes to it.
    Its gradient goes through :class:`_AllReduceSum`, whose backward sums
    the cotangents over the model group, as ``repro``'s autodiff of its
    all-reduce gives it.  That is NOT the replicated MLP's gradient: the
    output's cotangent is already the same on every rank, so each rank's
    input cotangent and weight-gradient blocks come out ``tp`` times its
    own partial, with no input-side reduce; use :func:`mlp_tp` where the
    gradients must equal :func:`mlp`'s."""
    tp = comm.topo.p()
    f = cfg.d_ff
    if f % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide d_ff={f}")
    fl = f // tp
    h = x @ _tp_cols(comm, p["w_up"], fl)
    if "w_gate" in p:
        h = _act(cfg.act)(x @ _tp_cols(comm, p["w_gate"], fl)) * h
    else:
        h = _act(cfg.act)(h)
    down = p["w_down"].narrow(0, comm.topo.global_rank() * fl, fl)
    return _AllReduceSum.apply(h @ down, comm, strategy)


class _AllReduceSum(torch.autograd.Function):
    """``comm.allreduce`` (a sum over the model group), whose backward is
    the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, comm, strategy):
        ctx.comm, ctx.strategy = comm, strategy
        return comm.allreduce(x.contiguous(), strategy=strategy)

    @staticmethod
    def backward(ctx, dy):
        return ctx.comm.allreduce(dy.contiguous(), strategy=ctx.strategy), \
            None, None


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, *, generator, device) -> dict:
    dt = torch_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"tok": dense_init((cfg.vocab_size, cfg.d_model), dt, scale=1.0,
                           **kw)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init((cfg.d_model, cfg.vocab_size), dt, **kw)
    return p


def embed(p: dict, tokens):
    return F.embedding(tokens, p["tok"])


def unembed(p: dict, x):
    if "head" in p:
        return x @ p["head"]
    return x @ p["tok"].T
