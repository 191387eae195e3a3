"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

The port's copy of ``repro.optim.adamw``.  The moments m and v are f32
and mirror the parameter tree; the step count is a Python int.  All math
is f32 and the parameters keep their dtype.  One departure, for memory:
``adamw_update`` writes the parameters, m and v in place (a functional
update of llama3.2-3b would hold a second 25.7 GB of moments), and
returns the same objects.

Weight decay follows ``repro``'s ranks.  ``repro`` decays the leaves of
rank >= 2, and stacks every layer's leaves along a leading L axis, so it
decays each layer's norm scales, ``dt_bias``, ``A_log``, ``D`` and conv
biases as well, and not ``final_norm`` or the hybrid's shared block's
norms.  The port keeps layers as a list, so a leaf inside a list counts
one rank more here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac``; in f32, as
    ``repro`` computes it."""
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t))
    frac = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * cos
    return float(f(cfg.lr) * warm * frac)


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": _tree.tree_map(zeros, params),
            "v": _tree.tree_map(zeros, params), "count": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device)."""
    return torch.stack([g.float().square().sum()
                        for g in _tree.leaves(tree)]).sum().sqrt()


def _decays(path, p) -> bool:
    """Whether ``repro`` decays this leaf: rank >= 2 in its layout, where
    a leaf in a list of layers has the stacked L axis too."""
    return p.ndim + _tree.is_stacked(path) >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, *,
                 grad_norm=None):
    """One AdamW step, in place: returns ``(params, state)``, the objects
    it was given, updated.  ``grads`` mirrors ``params`` (any float dtype)
    and is clipped by its global norm, or by ``grad_norm`` where given:
    the ZeRO steps pass the whole model's norm for the part of it that
    stays a tree (``launch/steps.py``), as ``repro``'s override does."""
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, count)
    f = np.float32
    c1 = float(f(1) - f(cfg.b1) ** f(count))
    c2 = float(f(1) - f(cfg.b2) ** f(count))
    for (path, p), g, m, v in zip(_tree.flatten(params), _tree.leaves(grads),
                                  _tree.leaves(state["m"]),
                                  _tree.leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        step = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        if _decays(path, p):
            step.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(step, alpha=lr))
    state["count"] = count
    return params, state
