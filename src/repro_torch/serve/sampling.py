"""Seeded sampling for the serving tier: replayable by construction.

Counterpart of ``repro.serve.sampling``, with its semantics.  Every
sampled token is a pure function of ``(seed, rid, position)``: the key is
``fold_in(fold_in(PRNGKey(seed), rid), position)``, drawn with the
bit-exact threefry of ``serve.prng``, so a request's token stream does
not depend on its batch, its slot or replays, and equals ``repro``'s.

The categorical draw is Gumbel-argmax over the temperature-scaled,
top-p-renormalized distribution: ``argmax(log p + g)`` never selects a
token with ``p == 0``.  ``sample_token`` takes a batch of rows, each with
its own rid and position, and draws for all of them in one pass on the
logits' device; only the token ids leave it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import prng

__all__ = ["SamplerConfig", "GREEDY", "request_key", "top_p_renormalize",
           "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyperparameters + the replay seed.

    temperature <= 0 is exact greedy (argmax, no random numbers drawn);
    top_p = 1.0 disables the nucleus filter.
    """
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplerConfig(temperature=0.0)


def request_key(seed: int, rid, position, device="cpu") -> torch.Tensor:
    """The (seed, rid, position) key contract, one key per sampled token:
    ``rid`` and ``position`` are ints or sequences of ints (one key per
    entry; taken mod 2**32, as ``repro``'s uint32 casts take them).
    Returns keys of shape (..., 2) on ``device``.  The few keys are
    hashed on the host and reach a card in one copy from pinned memory
    that does not wait for the card."""
    rid = torch.as_tensor(rid, dtype=torch.int64)
    key = prng.prng_key(seed).expand(*rid.shape, 2)
    key = prng.fold_in(prng.fold_in(key, rid), torch.as_tensor(position))
    device = torch.device(device)
    if device.type == "cuda":
        return key.pin_memory().to(device, non_blocking=True)
    return key.to(device)


def top_p_renormalize(probs, top_p: float):
    """Nucleus filter on the last axis: keep the smallest prefix of
    descending-probability tokens whose mass reaches ``top_p`` (the keep
    rule is exclusive-cumsum < top_p, so the top-1 token is always kept),
    zero the rest, renormalize.  Equal probabilities keep their index
    order (a stable sort, as jnp.argsort's)."""
    probs = probs.float()
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = torch.gather(probs, -1, order)
    exclusive = torch.cumsum(sorted_p, dim=-1) - sorted_p
    kept = torch.where(exclusive < top_p, sorted_p, 0.0)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    return torch.empty_like(kept).scatter_(-1, order, kept)


def sample_token(logits, sampler: SamplerConfig = None, rid=None,
                 position=None):
    """Token ids from unnormalized logits (..., V), one per row.

    Greedy (no sampler, or temperature <= 0): the first index of the
    maximum, as ``jnp.argmax`` picks it; ``rid`` and ``position`` are not
    read.  Otherwise: softmax at ``temperature`` in f32, the nucleus
    filter at ``top_p``, and a Gumbel-argmax draw keyed by (seed, rid,
    position), where ``rid`` and ``position`` are ints or tensors of the
    rows' batch shape."""
    logits = logits.float()
    if sampler is None or sampler.greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / sampler.temperature, dim=-1)
    if sampler.top_p < 1.0:
        probs = top_p_renormalize(probs, sampler.top_p)
    logp = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-38)),
                       -torch.inf)
    key = request_key(sampler.seed, rid, position, device=logits.device)
    if key.shape[:-1] != logits.shape[:-1]:
        raise ValueError(f"sample_token: {tuple(key.shape[:-1])} keys for "
                         f"logits rows {tuple(logits.shape[:-1])}")
    g = prng.gumbel(key, logits.shape[-1:])
    return torch.argmax(logp + g, dim=-1)
