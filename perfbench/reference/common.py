"""The plain reference's shared parts: precision, norms, rotary, causal
attention, the loss, AdamW and the three reference steps.

Plain PyTorch.  It imports nothing of the program and takes nothing the
program made: its weights come from ``perfbench.weights`` and its batches
from ``perfbench.traffic``, the same the program was given.  Every
operation runs in float32 with TF32 off.  The parameters are held in the
type the configuration stores them in (bfloat16, or float32 where the
configuration says so): after each update a parameter is rounded to that
type, as the program's in-place update rounds it.

``Precision`` is where the control lowers the arithmetic: with
``"fp8"`` every product of the projections, the attention, the experts
and the unembedding takes both operands through float8 (e4m3 forward,
e5m2 for the gradients flowing back, one scale a tensor), the nearest
precision below the configuration's bfloat16.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def _fake_quant(x, dtype, fmax):
    if x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = fmax / amax
    return ((x.float() * s).to(dtype).float() / s).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake_quant(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fake_quant(g, torch.float8_e5m2, 57344.0)


class Precision:
    """``mode``: ``"f32"`` (the reference) or ``"fp8"`` (the control)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r} not in ('f32', 'fp8')")
        self.mode = mode

    def q(self, x):
        return _Fp8.apply(x) if self.mode == "fp8" else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, T, H, D): rotary over split halves, positions 0..T-1."""
    T, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, prec):
    """q: (B, T, H, hd); k, v: (B, T, K, hd); query head h reads key head
    h // (H / K).  Returns (B, T, H·hd)."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = prec.ein("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.ein("bhqk,bkhd->bqhd", p, v).reshape(B, T, H * hd)


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over the labels >= 0."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1)


def cosine_lr(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac``, in float32."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(opt["warmup_steps"], 1)), f(1.0))
    t = np.clip((s - f(opt["warmup_steps"]))
                / f(max(opt["total_steps"] - opt["warmup_steps"], 1)),
                f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t))
    frac = f(opt["min_lr_frac"]) + f(1 - opt["min_lr_frac"]) * cos
    return float(f(opt["lr"]) * warm * frac)


def decays(name: str, shape) -> bool:
    """AdamW decays the matrices and every parameter of a layer, as the
    program's optimizer does."""
    return len(shape) >= 2 or name.startswith("blocks.")


class AdamW:
    """AdamW over named float32 parameters, clipped by the global norm
    of the gradient, decaying the parameters ``decays(name, shape)``
    picks (the program's rule, :func:`decays`).
    ``store[name]`` is the type each parameter is held in."""

    def __init__(self, opt: dict, params: dict, store: dict, decays):
        self.opt, self.store, self.count = opt, store, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.decay = {k: decays(k, p.shape) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        o = self.opt
        self.count += 1
        gnorm = torch.stack([g.square().sum() for g in grads.values()]) \
            .sum().sqrt()
        scale = torch.clamp(o["clip_norm"] / gnorm.clamp(min=1e-9), max=1.0)
        lr = cosine_lr(o, self.count)
        c1 = 1 - o["b1"] ** self.count
        c2 = 1 - o["b2"] ** self.count
        for k, p in params.items():
            g = grads[k] * scale
            m, v = self.m[k], self.v[k]
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (m / c1) / ((v / c2).sqrt() + o["eps"])
            if self.decay[k]:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
            p.copy_(p.to(self.store[k]).float())


def as_f32(weights: dict) -> dict:
    return {k: w.to(torch.float32, copy=True).requires_grad_(True)
            for k, w in weights.items()}


def train_steps(family, cfg: dict, weights: dict, batches, opt: dict,
                prec: Precision, mean_over_ranks=None) -> dict:
    """Three (or ``len(batches)``) reference steps from ``weights``.

    ``batches``: (tokens, labels) of this process's rows, one pair a
    step.  ``mean_over_ranks(tensors)``: averages the tensors over the
    processes in place (None on one process), so that the loss and the
    gradient of a step are those of the global batch.  Returns the
    readings the comparison takes: each step's loss, each parameter's
    norm of the first gradient as AdamW takes it (clipped), and each
    parameter's norm of the change after the last step."""
    store = {k: w.dtype for k, w in weights.items()}
    params = as_f32(weights)
    adamw = AdamW(opt, params, store, decays)
    losses, first = [], None
    for tokens, labels in batches:
        loss = family.loss(params, cfg, tokens, labels, prec,
                           layer_call=_layer_checkpoint)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = dict(zip(names, grads))
        loss = loss.detach().reshape(1)
        if mean_over_ranks is not None:
            mean_over_ranks([loss, *grads.values()])
        losses.append(float(loss))
        adamw.step(params, grads)
        del grads
        if first is None:
            first = {k: float(m.norm()) / (1 - opt["b1"])
                     for k, m in adamw.m.items()}
    change = {k: float((params[k].detach() - weights[k].float()).norm())
              for k in params}
    return {"losses": losses, "first_grad": first, "change": change}


def _layer_checkpoint(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


@contextlib.contextmanager
def f32_products():
    """float32 products in float32 inside: TF32 off, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
