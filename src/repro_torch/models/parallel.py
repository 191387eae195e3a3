"""ParallelContext: the routing of the third parallelism axis.

Counterpart of ``repro.models.parallel``.  The train and serve steps
(``launch/steps.py``, ``serve/steps.py``) enter a :func:`parallel_context`
around the forward, so that every layer body it runs sees one
tensor-parallel / expert-parallel configuration without extra arguments
through every family's signature.  The model code
(``transformer._ffn``, the scanned stack body) reads :func:`parallel_ctx`
and routes to :func:`repro_torch.models.layers.mlp_tp` (the TP layout
that equals the replicated MLP) or
:func:`repro_torch.models.moe.moe_block_ep` when an axis is active.

``repro``'s context is trace-time state, and its remat replays run inside
the same trace.  Here the forward runs eagerly and a recomputation under
``torch.utils.checkpoint`` runs in the backward, after the ``with`` block
has left: :func:`bound` wraps a function so that it enters the context
that was active when it was wrapped, and every checkpoint cell of the
port (``transformer._layer_runner``, ``blockstack.scan_stack``'s
re-gather) runs its function through it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

__all__ = ["ParallelContext", "parallel_ctx", "parallel_context", "bound"]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The active parallelism axes beyond data-parallel.

    tp / tp_comm: tensor-parallel degree and the model-axis ``LaneComm``
        the TP activation collectives resolve through (``tp <= 1`` or
        ``tp_comm is None`` disables TP routing).
    ep / ep_comm: expert-parallel token routing over ``ep_comm``'s
        node x lane decomposition (the batch ranks: every process owns
        E/p experts).
    ep_blocks: capacity blocks the routing all-to-all is pipelined over
        (1 = sequential).
    ep_experts: ``lane_zero3`` only, the local expert weights, one dict
        of (E/p, ...) leaves per layer, that the stack body puts in layer
        i's ``moe`` (the replicated layouts slice their whole expert
        weights by rank instead).
    """
    tp: int = 1
    tp_comm: Optional[Any] = None
    ep: bool = False
    ep_comm: Optional[Any] = None
    ep_blocks: int = 1
    ep_experts: Optional[Any] = None


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "parallel_ctx", default=ParallelContext())


def parallel_ctx() -> ParallelContext:
    """The active context (the all-defaults instance when none entered)."""
    return _CTX.get()


@contextlib.contextmanager
def _entered(ctx: ParallelContext):
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def parallel_context(**kw):
    """Enter a fresh :class:`ParallelContext` built from ``kw``."""
    return _entered(ParallelContext(**kw))


def bound(fn):
    """``fn`` running under the context active now, wherever it is called
    later (a checkpoint's recomputation in the backward)."""
    ctx = parallel_ctx()

    def run(*args, **kw):
        with _entered(ctx):
            return fn(*args, **kw)
    return run
