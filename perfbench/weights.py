"""The benchmark's weights: made from the seed on the device, in a few
large calls, in the type each is held in.

A family module under ``perfbench/reference/`` lists its parameters as
``(name, shape, dtype, init)``; ``init`` is one of

  ("normal", std)          normal draws times std
  ("ones",) / ("zeros",)
  ("log_uniform", lo, hi)  log of a uniform draw on [lo, hi] (A_log)
  ("dt_bias", lo, hi)      inverse softplus of a step size drawn
                           log-uniformly on [lo, hi]

Every normal draw comes from one stream of ``CHUNK``-element calls of a
``torch.Generator`` on the device, cut into the parameters in the order
listed, so the same seed gives the same weights on any card of a kind.
The same weights go to the program (cast into its tree by the driver)
and, made again after the window, to the reference.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63))


def make_weights(specs, seed: int, device) -> dict:
    """{name: tensor} on ``device``, each in its listed dtype."""
    dev = torch.device(device)
    gen = _generator(seed, dev)
    out = {name: torch.empty(shape, dtype=getattr(torch, dt), device=dev)
           for name, shape, dt, _ in specs}
    normal = [(name, init[1]) for name, _, _, init in specs
              if init[0] == "normal"]
    pending = [(name, 0) for name, _ in normal]
    std = dict(normal)
    total = sum(out[name].numel() for name, _ in normal)
    done = 0
    while done < total:
        n = min(CHUNK, total - done)
        draw = torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float32)
        used = 0
        while used < n:
            name, ofs = pending[0]
            flat = out[name].view(-1)
            take = min(flat.numel() - ofs, n - used)
            flat[ofs:ofs + take].copy_(draw[used:used + take] * std[name])
            used += take
            if ofs + take == flat.numel():
                pending.pop(0)
            else:
                pending[0] = (name, ofs + take)
        done += n
        del draw
    for name, shape, _, init in specs:
        kind = init[0]
        if kind == "ones":
            out[name].fill_(1.0)
        elif kind == "zeros":
            out[name].zero_()
        elif kind == "log_uniform":
            lo, hi = init[1], init[2]
            u = torch.rand(shape, generator=gen, device=dev)
            out[name].copy_(torch.log(u * (hi - lo) + lo))
        elif kind == "dt_bias":
            lo, hi = math.log(init[1]), math.log(init[2])
            u = torch.rand(shape, generator=gen, device=dev)
            dt = torch.exp(u * (hi - lo) + lo)
            out[name].copy_(dt + torch.log(-torch.expm1(-dt)))
        elif kind != "normal":
            raise ValueError(f"unknown init {init!r} for {name}")
    return out


def checksum(weights: dict) -> float:
    """Sum of every element in f64: the same weights made twice must give
    the same number."""
    return float(sum(w.double().sum().item() for w in weights.values()))
