"""Attention: GQA with optional QKV bias and sliding window.

Counterpart of ``repro.models.attention``.  Two compute paths:

* ``attention``         — full-sequence attention for prefill and the
                          no-cache forward.  It transposes to head-major
                          and calls ``kernels.ops.flash_attention``: K1 on
                          a CUDA tensor, its plain version on a CPU one.
                          (``repro`` computes the same function with its
                          lax path ``attention_xla``.)
* ``decode_attention``  — one new query against a KV cache, plain tensor
                          code (``repro`` has no kernel for it either).

Projections are kept flat (d → H·hd) as in ``repro``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import apply_rope, dense_init, torch_dtype

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, *, generator, device) -> dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    dt = torch_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"wq": dense_init((d, H * hd), dt, **kw),
         "wk": dense_init((d, K * hd), dt, **kw),
         "wv": dense_init((d, K * hd), dt, **kw),
         "wo": dense_init((H * hd, d), dt, **kw)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((K * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((K * hd,), dtype=dt, device=device)
    return p


def qkv(p: dict, x, cfg: ModelConfig, positions=None, rope: bool = True):
    """x: (B, T, d) → q (B,T,H,hd), k/v (B,T,K,hd), rotary applied."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, K, hd)
    v = v.reshape(B, T, K, hd)
    if rope:
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(q, k, v, *, causal: bool, window: int = 0):
    """q: (B, Tq, H, hd); k, v: (B, Tk, K, hd) → (B, Tq, H, hd) in q.dtype.

    The kernel takes head-major contiguous tensors, so the inputs are
    transposed and copied once here."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q, kcache, vcache, cache_len, *, window: int = 0):
    """q: (B, 1, H, hd); caches: (B, S, K, hd); cache_len: (B,) or scalar
    count of valid cache positions, the query's own included.  Scores and
    the PV sum are f32; p is cast to the cache's type before PV, as in
    ``repro``.

    The window keeps the keys at positions >= qpos - window (qpos =
    cache_len - 1): window + 1 keys, as K1, the no-cache forward and
    ``repro``'s prefill keep them, so that a cached decode step equals the
    no-cache forward at every length.  ``repro``'s own ``decode_attention``
    keeps one key fewer (positions >= cache_len - window); the port departs
    from it there (ROADMAP.md, Queue 3)."""
    B, _, H, hd = q.shape
    S, K = kcache.shape[1], kcache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qh = (q[:, 0] * scale).reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), kcache.float())
    cache_len = torch.as_tensor(cache_len, device=q.device)
    if cache_len.ndim == 0:
        cache_len = cache_len.expand(B)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    if window:
        valid = valid & (pos[None, :] >= cache_len[:, None] - 1 - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    num = torch.einsum("bkgs,bskd->bkgd", p.to(vcache.dtype).float(),
                       vcache.float())
    out = num / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)
