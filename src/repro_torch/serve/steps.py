"""Serving steps: the ``replicated`` hosting.

Counterpart of ``repro.serve.steps``.  ``repro`` resolves each hosting
flavour from its ``("serve_step", ...)`` registry and jits four entry
points; here the one ported hosting, ``replicated`` (every device holds
full weights), is a plain table entry and the entry points run eagerly.
``lane_zero3`` (1/p weight hosting over the lane collectives) comes with
the ZeRO slice of ROADMAP.md and raises until then.

A :class:`ServeStep` is hosting-agnostic to its caller (the engine):

  prepare(params) -> hosted          lay the replicated params out
  init_state() -> ServeState         batched (slots) zero state
  prefill(hosted, toks (1, b), true_len, extra=None)
      -> (logits (1, 1, V) at the last true position, batch-1 state);
      ``extra``: the vlm patches or audio frames, (1, n, d) f32
  decode(hosted, tok (slots, 1), state) -> (logits (slots, 1, V), state)
  splice(state, state1, slot) -> state   write the batch-1 state into
      ``slot`` in place

``prefill``, ``decode`` and ``splice`` run under ``torch.no_grad()``:
serving asks for no gradient, and the kernels' wrappers refuse an input
that requires grad while grad mode is on (they have no backward yet).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (ServeState, decode_step, init_cache,
                                prefill)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import check_family

__all__ = ["ServeContext", "ServeStep", "build_serve_step", "HOSTINGS"]


@dataclasses.dataclass(frozen=True)
class ServeContext:
    """Everything a serve-step builder needs.  slots: decode batch width;
    device: where the state lives (the params must be there too)."""
    cfg: ModelConfig
    max_seq: int
    slots: int
    device: torch.device


@dataclasses.dataclass
class ServeStep:
    """One hosting flavour's serving surface (see module docstring)."""
    hosting: str
    cfg: ModelConfig
    ctx: ServeContext
    prepare: Callable
    init_state: Callable
    prefill: Callable
    decode: Callable
    splice: Callable


def _init_serve_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> ServeState:
    """Zero ServeState at the model compute dtype (audio gets a zero
    batched ``enc_kv`` that each request's splice fills)."""
    dt = torch_dtype(cfg)
    cache = init_cache(cfg, batch, max_seq, dtype=dt, device=device)
    enc_kv = None
    if cfg.family == "audio":
        shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.hd())
        enc_kv = {"k": torch.zeros(shape, dtype=dt, device=device),
                  "v": torch.zeros(shape, dtype=dt, device=device)}
    return ServeState(cache=cache,
                      length=torch.zeros((batch,), dtype=torch.int32,
                                         device=device),
                      enc_kv=enc_kv)


# every stacked cache leaf — kv (L, B, S, K, hd), the stacked Mamba2
# states (L, B, ...), the hybrid's grouped kv (groups, B, S, K, hd), the
# audio enc_kv (L, B, Te, K, hd) — keeps the batch at axis 1
_BATCH_AXIS = 1


def _splice_leaf(big, small, slot, axis=_BATCH_AXIS):
    """Write ``small`` (batch 1) into row ``slot`` of ``big``, in place."""
    big.narrow(axis, slot, 1).copy_(small)


def _splice_tree(big, small, slot):
    """``_splice_leaf`` over every leaf of a (nested) cache dict."""
    for name, leaf in big.items():
        if isinstance(leaf, dict):
            _splice_tree(leaf, small[name], slot)
        else:
            _splice_leaf(leaf, small[name], slot)


def _serve_replicated(ctx: ServeContext) -> ServeStep:
    cfg, dev = ctx.cfg, ctx.device

    def _init():
        return _init_serve_state(cfg, ctx.slots, ctx.max_seq, dev)

    @torch.no_grad()
    def _prefill(params, toks, true_len, extra=None):
        # a batch-1 cache of the family's own structure
        cache1 = init_cache(cfg, 1, ctx.max_seq, dtype=torch_dtype(cfg),
                            device=dev)
        toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
        if extra is not None:
            extra = torch.as_tensor(extra, dtype=torch.float32, device=dev)
        return prefill(params, cfg, toks, cache1, extra_embeds=extra,
                       true_len=true_len)

    @torch.no_grad()
    def _decode(params, tok, state):
        tok = torch.as_tensor(tok, dtype=torch.long, device=dev)
        return decode_step(params, cfg, tok, state)

    @torch.no_grad()
    def _splice(state, st1, slot):
        _splice_tree(state.cache, st1.cache, int(slot))
        if state.enc_kv is not None:
            _splice_tree(state.enc_kv, st1.enc_kv, int(slot))
        _splice_leaf(state.length, st1.length, int(slot), axis=0)
        return state

    return ServeStep(hosting="replicated", cfg=cfg, ctx=ctx,
                     prepare=lambda params: params, init_state=_init,
                     prefill=_prefill, decode=_decode, splice=_splice)


def _serve_zero3(ctx: ServeContext) -> ServeStep:
    raise NotImplementedError(
        "hosting 'lane_zero3' is not ported yet; it comes with the ZeRO "
        "slice of ROADMAP.md (Queue 1, item 9b)")


HOSTINGS = {"replicated": _serve_replicated, "lane_zero3": _serve_zero3}


def build_serve_step(cfg: ModelConfig, *, max_seq: int, slots: int,
                     hosting: str = "replicated",
                     device="cuda") -> ServeStep:
    """Build ``hosting`` for ``cfg`` on ``device``."""
    if hosting not in HOSTINGS:
        raise ValueError(f"unknown serving hosting {hosting!r}; have "
                         f"{tuple(HOSTINGS)}")
    check_family(cfg)
    ctx = ServeContext(cfg=cfg, max_seq=int(max_seq), slots=int(slots),
                       device=resolve_device(device))
    return HOSTINGS[hosting](ctx)
