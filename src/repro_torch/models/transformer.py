"""Model assembly and serving forwards for the dense, ssm and hybrid
families.

Counterpart of ``repro.models.transformer`` for three families:

  dense  — llama-style pre-norm blocks (GQA attention + gated MLP)
  ssm    — Mamba2 blocks only (attention-free)
  hybrid — a Mamba2 backbone and ONE weight-shared attention block
           applied before every ``hybrid_attn_every`` Mamba2 layers
           (Zamba2), then the tail of Mamba2 layers

over a tied or untied embedding.  ``repro`` stacks every layer's weights
along a leading L axis and scans over them; here ``params["blocks"]`` is
a list of per-layer dicts and a Python loop walks it.  The caches stay
stacked, every leaf with its batch on axis 1: dense ``{"k", "v"}`` of
shape (L, B, S, K, hd); ssm the Mamba2 state ``{"conv_x", "conv_B",
"conv_C", "ssm"}`` with a leading L; hybrid ``{"mamba": <the ssm cache>,
"attn": {"k", "v"} with one entry per group}``.  The serving forwards
write them in place.  Any other family raises ``NotImplementedError``
naming the ROADMAP.md slice that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from . import attention as A
from . import layers as L
from . import ssm as S

_FAMILIES = ("dense", "ssm", "hybrid")
# which ROADMAP.md Queue 1 slice ports each family that is not here yet
_FAMILY_SLICE = {
    "moe": "Queue 1, item 4: the remaining serving families (moe)",
    "vlm": "Queue 1, item 4: the remaining serving families (vlm)",
    "audio": "Queue 1, item 4: the remaining serving families (audio)",
}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; it "
            f"comes with ROADMAP.md "
            f"{_FAMILY_SLICE.get(cfg.family, 'Queue 1')}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, device):
    if cfg.norm == "layernorm":
        return L.init_layernorm(cfg.d_model, L.torch_dtype(cfg), device)
    return L.init_rmsnorm(cfg.d_model, L.torch_dtype(cfg), device)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    with ``repro``'s init distribution.  ``device="meta"`` gives the
    parameter template (shapes and types, no storage)."""
    check_family(cfg)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    params: dict[str, Any] = {"embed": L.init_embed(cfg, **kw),
                              "final_norm": _init_norm(cfg, dev)}
    layer = _init_attn_layer if cfg.family == "dense" else _init_mamba_layer
    params["blocks"] = [layer(cfg, **kw) for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_attn_layer(cfg, **kw)
    return params


def _init_attn_layer(cfg: ModelConfig, *, generator, device) -> dict:
    kw = dict(generator=generator, device=device)
    return {"ln1": _init_norm(cfg, device),
            "attn": A.init_attention(cfg, **kw),
            "ln2": _init_norm(cfg, device),
            "mlp": L.init_mlp(cfg, **kw)}


def _init_mamba_layer(cfg: ModelConfig, *, generator, device) -> dict:
    return {"ln1": _init_norm(cfg, device),
            "mamba": S.init_mamba2(cfg, generator=generator, device=device)}


# ---------------------------------------------------------------------------
# no-cache forward (the consistency checks' reference for the cached path)
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x):
    return L.apply_norm(p, x, cfg.norm_eps)


def _ffn(lp, h, cfg: ModelConfig):
    return h + L.mlp(lp["mlp"], _norm(cfg, lp["ln2"], h), cfg)


def _attn_block(lp, h, cfg: ModelConfig, positions):
    """Pre-norm causal attention and MLP over the whole sequence."""
    Bz, T, _ = h.shape
    hn = _norm(cfg, lp["ln1"], h)
    q, k, v = A.qkv(lp["attn"], hn, cfg, positions=positions)
    o = A.attention(q, k, v, causal=True, window=cfg.sliding_window)
    h = h + o.reshape(Bz, T, -1) @ lp["attn"]["wo"]
    return _ffn(lp, h, cfg)


def _mamba_block(lp, h, cfg: ModelConfig, state=None):
    """Pre-norm Mamba2 block; ``state`` as in ``ssm.mamba2_block``."""
    out, new_state = S.mamba2_block(lp["mamba"], _norm(cfg, lp["ln1"], h),
                                    cfg, state=state)
    return h + out, new_state


def _hybrid_split(cfg: ModelConfig):
    """(groups, every, tail): each group is the shared attention block and
    then ``every`` Mamba2 layers; ``tail`` Mamba2 layers follow."""
    every = cfg.hybrid_attn_every
    groups = cfg.num_layers // every
    return groups, every, cfg.num_layers - groups * every


def _shared_attn_group(cfg: ModelConfig, i: int):
    """The hybrid group whose shared attention block runs just before
    Mamba2 layer ``i``, or None."""
    if cfg.family != "hybrid":
        return None
    groups, every, _ = _hybrid_split(cfg)
    return i // every if i < groups * every and i % every == 0 else None


def model_forward(params, cfg: ModelConfig, tokens):
    """Full forward to logits.  tokens: (B, T) int.  Returns
    ``(logits (B, T, V), aux_loss)``; these families have no aux loss."""
    h = L.embed(params["embed"], tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    if cfg.family == "dense":
        for lp in params["blocks"]:
            h = _attn_block(lp, h, cfg, positions)
    else:
        for i, lp in enumerate(params["blocks"]):
            if _shared_attn_group(cfg, i) is not None:
                h = _attn_block(params["shared_attn"], h, cfg, positions)
            h, _ = _mamba_block(lp, h, cfg)
    h = _norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], h), 0.0


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeState:
    """Serving state.  ``cache``: the family's stacked cache (module
    docstring), written in place by ``prefill`` and ``decode_step``;
    ``length``: (B,) int32 count of positions consumed per row."""
    cache: dict
    length: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero cache.  ``dtype`` is the KV cache's; the Mamba2 state is f32,
    as ``repro``'s ``init_mamba_state`` makes it."""
    check_family(cfg)
    dev = resolve_device(device)

    def kv(n):
        shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.hd())
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    if cfg.family == "dense":
        return kv(cfg.num_layers)
    mamba = {name: torch.zeros((cfg.num_layers, *a.shape), dtype=a.dtype,
                               device=dev)
             for name, a in S.init_mamba_state(cfg, batch,
                                               device="meta").items()}
    if cfg.family == "ssm":
        return mamba
    return {"mamba": mamba, "attn": kv(_hybrid_split(cfg)[0])}


def _attn_cached(lp, h, cfg: ModelConfig, kc, vc, length, *,
                 prefill: bool):
    """Attention with cache read and write.  h: (B, T, d); kc, vc: this
    layer's (B, S, K, hd) cache, written in place.

    prefill: writes positions [0, T) and attends within the new block
             (through K1 on the card).
    decode:  T == 1; writes row b at position ``length[b]`` in place (a
             row whose length has reached S is left as it is, as in
             ``repro``) and attends to ``length + 1`` positions.
    """
    Bz, T, _ = h.shape
    positions = torch.arange(T, device=h.device)[None] if prefill \
        else length[:, None]
    hn = _norm(cfg, lp["ln1"], h)
    q, k, v = A.qkv(lp["attn"], hn, cfg, positions=positions)
    if prefill:
        kc[:, :T] = k
        vc[:, :T] = v
        o = A.attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        S = kc.shape[1]
        rows = torch.arange(Bz, device=h.device)
        at = length.clamp(max=S - 1).long()
        inside = (length < S)[:, None, None]
        kc[rows, at] = torch.where(inside, k[:, 0].to(kc.dtype), kc[rows, at])
        vc[rows, at] = torch.where(inside, v[:, 0].to(vc.dtype), vc[rows, at])
        o = A.decode_attention(q, kc, vc, length + 1,
                               window=cfg.sliding_window)
    h = h + o.reshape(Bz, T, -1) @ lp["attn"]["wo"]
    return _ffn(lp, h, cfg)


def _mamba_cached(lp, h, cfg: ModelConfig, mcache, i: int):
    """Mamba2 block from layer ``i`` of the stacked state ``mcache``, whose
    leaves it then overwrites in place with the new state."""
    layer = {name: a[i] for name, a in mcache.items()}
    h, new = _mamba_block(lp, h, cfg, state=layer)
    for name, a in layer.items():
        a.copy_(new[name])
    return h


def _layers_cached(params, cfg: ModelConfig, h, cache, length, *,
                   prefill: bool):
    """Every layer of the family against its cache, in place."""
    if cfg.family == "dense":
        for i, lp in enumerate(params["blocks"]):
            h = _attn_cached(lp, h, cfg, cache["k"][i], cache["v"][i],
                             length, prefill=prefill)
        return h
    mcache = cache["mamba"] if cfg.family == "hybrid" else cache
    for i, lp in enumerate(params["blocks"]):
        g = _shared_attn_group(cfg, i)
        if g is not None:
            h = _attn_cached(params["shared_attn"], h, cfg,
                             cache["attn"]["k"][g], cache["attn"]["v"][g],
                             length, prefill=prefill)
        h = _mamba_cached(lp, h, cfg, mcache, i)
    return h


def _select_row(h, pos):
    """(B, T, d) -> (B, 1, d): row ``pos[b]`` of each batch element."""
    return h[torch.arange(h.shape[0], device=h.device), pos][:, None]


def prefill(params, cfg: ModelConfig, tokens, cache, *, true_len=None):
    """Run the prompt and fill ``cache`` in place.  Returns
    ``(logits (B, 1, V), ServeState)``.

    ``true_len`` (int or (B,) ints) marks the valid prompt length when
    ``tokens`` is right-padded to a bucket: the logits are taken at the
    last true position and ``state.length`` is ``true_len``, so decode
    overwrites the pad region and attention never reads past it.  The
    recurrent families (ssm, hybrid) fold every token they are given into
    their state, so their callers prefill at the exact prompt length (the
    engine does).
    """
    h = L.embed(params["embed"], tokens)
    Bz, T, _ = h.shape
    length0 = torch.zeros((Bz,), dtype=torch.int32, device=h.device)
    h = _layers_cached(params, cfg, h, cache, length0, prefill=True)
    if true_len is None:
        h_last = h[:, -1:]
        length = torch.full((Bz,), T, dtype=torch.int32, device=h.device)
    else:
        length = torch.as_tensor(true_len, dtype=torch.int32,
                                 device=h.device).expand(Bz).clone()
        h_last = _select_row(h, length.long() - 1)
    h_last = _norm(cfg, params["final_norm"], h_last)
    logits = L.unembed(params["embed"], h_last)
    return logits, ServeState(cache=cache, length=length)


def decode_step(params, cfg: ModelConfig, token, state: ServeState):
    """One token for every row.  token: (B, 1) int.  Writes the cache in
    place; the returned state shares it and has ``length + 1``."""
    h = L.embed(params["embed"], token)
    h = _layers_cached(params, cfg, h, state.cache, state.length,
                       prefill=False)
    h = _norm(cfg, params["final_norm"], h)
    logits = L.unembed(params["embed"], h)
    return logits, ServeState(cache=state.cache, length=state.length + 1)
