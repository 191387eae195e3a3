"""Mixture-of-Experts layer: token-choice top-k routing, capacity dispatch.

Counterpart of ``repro.models.moe`` (``init_moe``, ``_route``,
``_capacity``, ``_dispatch_buffer``, ``_combine``, ``moe_block``); the
expert-parallel variant (``moe_block_ep``) is not ported yet.

Dispatch is per batch row: each row's (token, k) assignments are ranked
within their expert, and an expert keeps the first ``C`` of them, with
``C = max(8, ceil8(int(capacity_factor · K · T / E)))`` for a row of
``T`` tokens (at prefill the bucket, pad tokens included).  Ranks come
from a stable sort of the flat (t, k) expert ids, so the earlier token
wins a slot and the pad tokens, which lie after the prompt, rank last.
An assignment past its expert's capacity goes to a trash slot ``E·C``
and contributes nothing.  The expert FFN is a batched product over the
(B, E, C, d) slot buffer, as in ``repro``, which computes it outside any
Pallas kernel; dispatch and combine are gathers and scatters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import _act, dense_init, torch_dtype

__all__ = ["init_moe", "moe_block"]


def init_moe(cfg: ModelConfig, *, generator, device) -> dict:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, torch_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init((d, E), dt, **kw),
         "w_up": dense_init((E, d, f), dt, **kw),
         "w_down": dense_init((E, f, d), dt, **kw)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((E, d, f), dt, **kw)
    return p


def _route(p, x, cfg: ModelConfig):
    """x: (B, T, d) → (probs (B,T,K), experts (B,T,K), aux_loss scalar)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = (x @ p["router"]).float()                   # product in x's dtype
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower expert index; torch.topk does
    # not promise an order among equals, a stable descending sort does
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss (Switch-style): E · Σ_e f_e · P_e
    density = F.one_hot(top_e, E).float().mean(dim=(1, 2))   # (B, E)
    p_mean = probs.mean(dim=1)                               # (B, E)
    aux = E * (density * p_mean).sum(-1).mean()
    return top_p, top_e, aux


def _capacity(cfg: ModelConfig, T: int) -> int:
    E, K = cfg.num_experts, cfg.experts_per_token
    c = int(cfg.moe_capacity_factor * K * T / E)
    return max(8, -(-c // 8) * 8)                        # round up to 8


def _dispatch_buffer(p: dict, x, cfg: ModelConfig):
    """Route, assign slots and scatter the tokens into the (B, E, C, d)
    buffer.  Returns ``(buf, slot, keep, top_p, aux, C)``; ``slot`` and
    ``keep`` are (B, T·K) in (t, k) order."""
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    top_p, top_e, aux = _route(p, x, cfg)

    # rank of each (t, k) within its expert: position in the stable sort
    # of the flat expert ids, less the number of earlier experts' entries
    TK = T * K
    flat_e = top_e.reshape(B, TK)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, sort_idx)
    hist = torch.zeros((B, E), dtype=flat_e.dtype, device=x.device)
    hist.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = hist.cumsum(1) - hist                        # exclusive prefix
    pos = torch.arange(TK, device=x.device).expand(B, TK)
    rank = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, pos - start.gather(1, sorted_e))    # back to (t, k) order
    keep = rank < C                                      # overflow dropped
    slot = torch.where(keep, flat_e * C + rank, E * C)   # E*C = trash slot

    xe = x.repeat_interleave(K, dim=1) if K > 1 else x   # (B, TK, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None]
    # every kept slot is written once; the trash row takes every dropped
    # assignment, and which of them lands there is left open — it does not
    # matter, because that row is cut off here and never read
    buf[rows, slot] = xe
    return buf[:, :-1].reshape(B, E, C, d), slot, keep, top_p, aux, C


def _combine(y, slot, keep, top_p, x, cfg: ModelConfig):
    """Gather the expert outputs ``y`` (B, E, C, d) back to token order,
    weighted by the router's probability; a dropped assignment reads the
    zero row at the trash slot."""
    B, T, d = x.shape
    K = cfg.experts_per_token
    y = y.reshape(B, -1, d)
    y = torch.cat([y, y.new_zeros((B, 1, d))], dim=1)
    gathered = y[torch.arange(B, device=x.device)[:, None], slot]  # (B,TK,d)
    w = (top_p.reshape(B, T * K) * keep).to(x.dtype)
    return (gathered * w[..., None]).reshape(B, T, K, d).sum(dim=2)


def moe_block(p: dict, x, cfg: ModelConfig):
    """Capacity-based dispatch; returns ``(out (B, T, d), aux_loss)``."""
    buf, slot, keep, top_p, aux, _ = _dispatch_buffer(p, x, cfg)
    h = torch.einsum("becd,edf->becf", buf, p["w_up"])
    if "w_gate" in p:
        h = _act(cfg.act)(torch.einsum("becd,edf->becf", buf,
                                       p["w_gate"])) * h
    else:
        h = _act(cfg.act)(h)
    y = torch.einsum("becf,efd->becd", h, p["w_down"])   # (B, E, C, d)
    return _combine(y, slot, keep, top_p, x, cfg), aux
