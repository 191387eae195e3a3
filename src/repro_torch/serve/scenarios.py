"""Serving scenario generator for every family.

Counterpart of ``repro.serve.scenarios``: the same numpy request mixes,
drawn from the same seed sequence in the same order, so both packages
serve byte-identical requests, extras included.  ``repro`` keys its
generators on a registry of families; here one generator serves every
family, and adds the synthesized extras of the vlm (patches) and audio
(frames) requests.

Kinds (``SCENARIO_KINDS``):

  short_chat     short prompts, short outputs, all at step 0
  long_context   prompts spanning several buckets (incl. one straddling
                 a bucket boundary), modest outputs
  bursty         arrival_step waves — slots drain and refill mid-stream
  mixed          long-context + short-chat interleaved, staggered
                 arrivals: the closest thing to production traffic
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.configs.base import ModelConfig

from .engine import Request

__all__ = ["SCENARIO_KINDS", "make_scenario"]

SCENARIO_KINDS = ("short_chat", "long_context", "bursty", "mixed")


def _lengths(kind: str, budget: int, n: int,
             rng: np.random.Generator) -> list:
    """(prompt_len, max_new, arrival_step) per request."""
    rows = []
    for i in range(n):
        if kind == "short_chat":
            L = int(rng.integers(3, min(16, budget // 2)))
            out = int(rng.integers(4, 9))
            arrive = 0
        elif kind == "long_context":
            # span buckets: one request pinned to exactly 2/3 of budget,
            # the rest spread wide (incl. > the 32 bucket)
            hi = max(8, budget - 12)
            L = (2 * budget) // 3 if i == 0 else int(rng.integers(8, hi))
            out = int(rng.integers(4, 9))
            arrive = 0
        elif kind == "bursty":
            L = int(rng.integers(3, min(24, budget // 2)))
            out = int(rng.integers(4, 9))
            arrive = 6 * (i // 3)          # waves of 3
        else:  # mixed
            long = i % 3 == 0
            hi = max(9, budget - 12)
            L = int(rng.integers(8, hi)) if long \
                else int(rng.integers(3, 12))
            out = int(rng.integers(4, 13))
            arrive = int(rng.integers(0, 10))
        out = max(1, min(out, budget - L))
        rows.append((max(1, min(L, budget - out)), out, arrive))
    return rows


def _budget(cfg: ModelConfig, max_seq: int) -> int:
    """Positions available to prompt + output (vlm pays its prefix)."""
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    return max_seq - prefix


def _requests(cfg: ModelConfig, *, kind: str, n: int, seed: int,
              max_seq: int, extra_fn=None) -> list:
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode())]))
    budget = _budget(cfg, max_seq)
    if budget < 8:
        raise ValueError(
            f"max_seq={max_seq} leaves a {budget}-token budget for "
            f"family {cfg.family!r} — too small for a scenario")
    reqs = []
    for i, (L, out, arrive) in enumerate(_lengths(kind, budget, n, rng)):
        prompt = rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
        reqs.append(Request(
            rid=i, prompt=prompt, max_new_tokens=out, arrival_step=arrive,
            extra=None if extra_fn is None else extra_fn(rng)))
    return reqs


# the families with a generator (every family of the zoo)
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _extra_fn(cfg: ModelConfig):
    """The draw of each request's Request.extra: vlm patch embeddings
    (vision_tokens, d_model), audio frame embeddings (encoder_seq,
    d_model); None for the families that serve plain prompts."""
    n = {"vlm": cfg.vision_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return None
    return lambda rng: rng.standard_normal(
        (n, cfg.d_model)).astype(np.float32) * 0.02


def make_scenario(cfg: ModelConfig, *, kind: str, n: int, seed: int,
                  max_seq: int) -> list:
    """``n`` deterministic Requests for ``cfg.family`` (ValueError on a
    family without a generator here, or an unknown kind)."""
    if kind not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario kind {kind!r}; one of "
                         f"{SCENARIO_KINDS}")
    if cfg.family not in _FAMILIES:
        raise ValueError(
            f"no serving scenario for family {cfg.family!r}; have "
            f"{_FAMILIES}")
    return _requests(cfg, kind=kind, n=n, seed=seed, max_seq=max_seq,
                     extra_fn=_extra_fn(cfg))
