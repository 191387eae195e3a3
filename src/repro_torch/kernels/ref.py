"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref``.  ``attention_ref`` is the plain
version of K1 (``kernels/flash_attention.py``): the CPU path of
``kernels.ops.flash_attention``, and the yardstick the kernel is held to
on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive softmax attention.  q: (B,H,Tq,hd); k,v: (B,K,Tk,hd)."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(hd), kf)
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos >= qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)
