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
