"""Sampling for the serving tier: greedy only, so far.

Counterpart of ``repro.serve.sampling``.  ``repro`` keys every sampled
token on ``fold_in(fold_in(PRNGKey(seed), rid), position)`` and draws
Gumbel noise with jax's threefry; a port that is token-identical to it
needs a bit-exact threefry2x32, which ROADMAP.md queues.  Until then a
``SamplerConfig`` with ``temperature > 0`` raises.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplerConfig", "GREEDY", "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyperparameters + the replay seed.

    temperature <= 0 is exact greedy (argmax); top_p = 1.0 disables the
    nucleus filter.
    """
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplerConfig(temperature=0.0)


def sample_token(logits, sampler: SamplerConfig = None):
    """Token ids from unnormalized logits (..., V): the first index of the
    maximum, as ``np.argmax`` and ``jnp.argmax`` pick it."""
    if sampler is not None and not sampler.greedy:
        raise NotImplementedError(
            "temperature > 0 needs the threefry sampler, which is not "
            "ported yet (ROADMAP.md, Queue 1, item 5)")
    return torch.argmax(logits.float(), dim=-1)
