"""Serving scenario generator for the plain families.

Counterpart of ``repro.serve.scenarios``: the same numpy request mixes,
drawn from the same seed sequence, so both packages serve byte-identical
requests.  ``repro`` keys its generators on a registry of families; here
a tuple names the plain families (vlm and audio, whose requests carry
synthesized extras, come with their serving slice).

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


def _requests(cfg: ModelConfig, *, kind: str, n: int, seed: int,
              max_seq: int) -> list:
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode())]))
    budget = max_seq
    if budget < 8:
        raise ValueError(
            f"max_seq={max_seq} leaves a {budget}-token budget for "
            f"family {cfg.family!r} — too small for a scenario")
    reqs = []
    for i, (L, out, arrive) in enumerate(_lengths(kind, budget, n, rng)):
        prompt = rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=out,
                            arrival_step=arrive))
    return reqs


_PLAIN_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def make_scenario(cfg: ModelConfig, *, kind: str, n: int, seed: int,
                  max_seq: int) -> list:
    """``n`` deterministic Requests for ``cfg.family`` (ValueError on a
    family without a generator here, or an unknown kind)."""
    if kind not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario kind {kind!r}; one of "
                         f"{SCENARIO_KINDS}")
    if cfg.family not in _PLAIN_FAMILIES:
        raise ValueError(
            f"no serving scenario for family {cfg.family!r}; have "
            f"{_PLAIN_FAMILIES}")
    return _requests(cfg, kind=kind, n=n, seed=seed, max_seq=max_seq)
