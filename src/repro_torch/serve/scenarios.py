"""Serving scenario generator for every family.

Counterpart of ``repro.serve.scenarios``: the same numpy request mixes,
drawn from the same seed sequence in the same order, so both packages
serve byte-identical requests, extras included.  ``repro`` keys its
generators on a registry of families, and so does the port: each family
is a ``("serve_scenario", family)`` cell (``scenario_families`` lists
them), the plain families drawing prompts only, vlm and audio adding
the synthesized patches or frames in ``Request.extra``.

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

from repro_torch.comm.registry import (get_impl, has_impl, register_impl,
                                       strategies_for)
from repro_torch.configs.base import ModelConfig

from .engine import Request

__all__ = ["SCENARIO_KINDS", "make_scenario", "scenario_families"]

SCENARIO_KINDS = ("short_chat", "long_context", "bursty", "mixed")


def scenario_families() -> tuple:
    """Families the serving tier supports (derived from the registry)."""
    return strategies_for("serve_scenario")


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


def _register_plain(family: str):
    @register_impl("serve_scenario", family, auto_ok=False)
    def _cell(cfg, *, kind, n, seed, max_seq):
        return _requests(cfg, kind=kind, n=n, seed=seed, max_seq=max_seq)
    return _cell


for _fam in ("dense", "moe", "ssm", "hybrid"):
    _register_plain(_fam)


def _gaussian(rows: int, cfg: ModelConfig):
    return lambda rng: rng.standard_normal(
        (rows, cfg.d_model)).astype(np.float32) * 0.02


@register_impl("serve_scenario", "vlm", auto_ok=False)
def _scenario_vlm(cfg, *, kind, n, seed, max_seq):
    """Patch embeddings (vision_tokens, d_model) ride in Request.extra."""
    return _requests(cfg, kind=kind, n=n, seed=seed, max_seq=max_seq,
                     extra_fn=_gaussian(cfg.vision_tokens, cfg))


@register_impl("serve_scenario", "audio", auto_ok=False)
def _scenario_audio(cfg, *, kind, n, seed, max_seq):
    """Frame embeddings (encoder_seq, d_model) ride in Request.extra."""
    return _requests(cfg, kind=kind, n=n, seed=seed, max_seq=max_seq,
                     extra_fn=_gaussian(cfg.encoder_seq, cfg))


def make_scenario(cfg: ModelConfig, *, kind: str, n: int, seed: int,
                  max_seq: int) -> list:
    """``n`` deterministic Requests for ``cfg.family`` (ValueError on an
    unregistered family or kind)."""
    if kind not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario kind {kind!r}; one of "
                         f"{SCENARIO_KINDS}")
    if not has_impl("serve_scenario", cfg.family):
        raise ValueError(
            f"no serving scenario for family {cfg.family!r}; registered: "
            f"{scenario_families()}")
    return get_impl("serve_scenario", cfg.family).fn(
        cfg, kind=kind, n=n, seed=seed, max_seq=max_seq)
