"""Threefry-2x32 counter-based random numbers, bit-exact with ``jax.random``.

``repro`` draws its sampling noise with ``jax.random`` under jax's
defaults: ``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True`` and 32-bit integers (x64 off).  This
module computes the same bits in PyTorch integer arithmetic, on whatever
device its inputs lie, so that a sampled token of the port is the token
``repro`` samples.

A key is an int64 tensor of shape (..., 2) holding the two uint32 words
of jax's raw key data; leading dimensions are a batch of keys, one per
row.  Every word is computed in int64 and masked to 32 bits after each
add and shift (PyTorch's uint32 has few kernels), so all values stay in
[0, 2**32): they are the uint32 bits, held in int64.

  prng_key(seed)         ``jax.random.PRNGKey(seed)``: with x64 off jax
                         first takes the seed to 32 bits, so the key is
                         (0, seed mod 2**32)
  threefry2x32(k, x)     the Threefry-2x32 block cipher, 20 rounds
  fold_in(key, data)     ``threefry2x32(key, (0, data))``
  random_bits(key, shape)   ``jax.random.bits`` (uint32), partitionable
                         layout: counter (hi, lo) = the flat index, bits =
                         the two output words xor'd
  uniform(key, shape)    ``jax.random.uniform`` in [minval, maxval), f32
  gumbel(key, shape)     ``jax.random.gumbel`` in its default "low" mode
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["prng_key", "threefry2x32", "fold_in", "random_bits", "uniform",
           "gumbel"]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA               # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000         # the bits of 1.0f
_F32_MANTISSA = 23
_F32_TINY = 1.1754943508222875e-38   # smallest normal float32


def _as_words(x, device=None) -> torch.Tensor:
    """An int or an integer tensor as int64 uint32 words (mod 2**32)."""
    t = torch.as_tensor(x, device=device)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"expected integers, got {t.dtype}")
    return t.to(torch.int64) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def prng_key(seed, device="cpu") -> torch.Tensor:
    """The raw key data of ``jax.random.PRNGKey(seed)``, shape (..., 2)."""
    lo = _as_words(seed, device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def threefry2x32(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 of the counter words (x1, x2) under ``key`` (..., 2),
    as jax's ``_threefry2x32_lowering``: five groups of four rounds with
    rotations (13, 15, 26, 6) and (17, 29, 16, 24), each group followed by
    a key injection.  Returns the two output words, broadcast."""
    ks = [key[..., 0], key[..., 1]]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    y1 = (x1 + ks[0]) & MASK32
    y2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y1 = (y1 + y2) & MASK32
            y2 = _rotl(y2, r) ^ y1
        y1 = (y1 + ks[(i + 1) % 3]) & MASK32
        y2 = (y2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return y1, y2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with ``threefry_seed(data)``
    = (0, data) as the counter.  ``data`` (an int or a tensor of the key's
    batch shape) is taken mod 2**32, as jax's uint32 cast takes it."""
    d = _as_words(data, key.device)
    y1, y2 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32), as int64 words of shape
    ``key.shape[:-1] + shape``: each key of a batch draws its own
    ``shape``.  The counter of element i (row-major flat index) is
    (i >> 32, i mod 2**32); the bits are the cipher's two words xor'd."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    batch = key.shape[:-1]
    k = key.reshape(*batch, *([1] * len(shape)), 2)
    y1, y2 = threefry2x32(k, (idx >> 32).reshape(shape),
                          (idx & MASK32).reshape(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits of ``random_bits``
    as the mantissa of a float in [1, 2), less 1, then
    ``max(minval, f * (maxval - minval) + minval)``, in f32 throughout."""
    bits = random_bits(key, shape)
    f = ((bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS).to(torch.int32) \
        .view(torch.float32) - 1.0
    # the bounds as f32 values, their difference rounded in f32, as jax
    # computes them (Python scalars: no copy to the device)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * span + lo, min=lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode (f32):
    ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))
