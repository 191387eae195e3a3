"""Model assembly, the training loss and serving forwards for every family.

Counterpart of ``repro.models.transformer``:

  dense  — llama-style pre-norm blocks (GQA attention + gated MLP)
  moe    — the same skeleton with the MLP swapped for the capacity MoE
  ssm    — Mamba2 blocks only (attention-free)
  hybrid — a Mamba2 backbone and ONE weight-shared attention block
           applied before every ``hybrid_attn_every`` Mamba2 layers
           (Zamba2), then the tail of Mamba2 layers
  vlm    — the dense backbone over [projected patch embeds | token embeds]
  audio  — Whisper: a bidirectional encoder over frame embeddings and a
           causal decoder with cross-attention in every layer

over a tied or untied embedding.  ``repro`` stacks every layer's weights
along a leading L axis and scans over them; here ``params["blocks"]`` (and
the audio ``params["encoder"]["blocks"]``) is a list of per-layer dicts
and a Python loop walks it, or, under ZeRO-3, a ``ShardedStack`` whose
layers ``models.blockstack.scan_stack`` gathers one by one into the
family's registered body (``register_block_stack``).  The caches stay stacked, every leaf with its
batch on axis 1: dense, moe, vlm and audio ``{"k", "v"}`` of shape (L, B,
S, K, hd); ssm the Mamba2 state ``{"conv_x", "conv_B", "conv_C", "ssm"}``
with a leading L; hybrid ``{"mamba": <the ssm cache>, "attn": {"k", "v"}
with one entry per group}``.  The serving forwards write them in place.
Audio serving also carries every decoder layer's cross K/V of the encoder
output (``ServeState.enc_kv``), computed once at prefill.  Training goes
through ``loss_fn`` over the no-cache forward, with ``remat="full"``
recomputing each layer in the backward (``torch.utils.checkpoint``) where
``repro`` wraps its scan body in ``jax.checkpoint``, and ``"dots"``
keeping its matmul outputs (a selective checkpoint policy) as
``repro``'s ``checkpoint_dots_with_no_batch_dims`` does.

One departure in bf16: ``repro`` adds the f32 frame embeddings to its
encoder's input, so by JAX's type promotion its encoder runs in f32 under
bf16 weights; here the encoder runs in the model's dtype (the frames plus
the learned positions are summed in f32, then cast).  In f32 the two are
the same computation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S
from .blockstack import (BlockSpec, ShardedStack, block_stack_spec,
                         register_block_stack, scan_stack, scan_stack_cached)
from .parallel import bound, parallel_ctx

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# families whose every layer is an attention block (one KV cache per layer)
_SCANNED_FAMILIES = ("dense", "vlm", "moe", "audio")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); "
                         f"have {_FAMILIES}")


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
    if cfg.family in _SCANNED_FAMILIES:
        cross = cfg.family == "audio"
        params["blocks"] = [_init_attn_layer(cfg, cross=cross, **kw)
                            for _ in range(cfg.num_layers)]
    else:
        params["blocks"] = [_init_mamba_layer(cfg, **kw)
                            for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_attn_layer(cfg, **kw)
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": [_init_attn_layer(cfg, **kw)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _init_norm(cfg, dev),
            "pos": L.dense_init((cfg.encoder_seq, cfg.d_model),
                                L.torch_dtype(cfg), scale=0.01, **kw)}
    if cfg.family == "vlm":
        params["vis_proj"] = L.dense_init((cfg.d_model, cfg.d_model),
                                          L.torch_dtype(cfg), **kw)
    return params


def _init_attn_layer(cfg: ModelConfig, *, generator, device,
                     cross: bool = False) -> dict:
    kw = dict(generator=generator, device=device)
    p = {"ln1": _init_norm(cfg, device),
         "attn": A.init_attention(cfg, **kw),
         "ln2": _init_norm(cfg, device)}
    if cfg.family == "moe":
        p["moe"] = M.init_moe(cfg, **kw)
    else:
        p["mlp"] = L.init_mlp(cfg, **kw)
    if cross:
        p["lnx"] = _init_norm(cfg, device)
        p["xattn"] = A.init_attention(cfg, **kw)
    return p


def _init_mamba_layer(cfg: ModelConfig, *, generator, device) -> dict:
    return {"ln1": _init_norm(cfg, device),
            "mamba": S.init_mamba2(cfg, generator=generator, device=device)}


# ---------------------------------------------------------------------------
# blocks (shared by the no-cache and cached paths)
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x):
    return L.apply_norm(p, x, cfg.norm_eps)


def _attn_noncache(lp, h, cfg: ModelConfig, *, causal: bool, positions,
                   window: int, kv=None):
    """Full-sequence pre-norm attention: self-attention, or with ``kv``
    given, cross-attention (``xattn``, no rotary) to those keys/values."""
    hn = _norm(cfg, lp["ln1"] if kv is None else lp["lnx"], h)
    ap = lp["attn"] if kv is None else lp["xattn"]
    if kv is None:
        q, k, v = A.qkv(ap, hn, cfg, positions=positions)
    else:
        q, _, _ = A.qkv(ap, hn, cfg, positions=positions, rope=False)
        k, v = kv
    o = A.attention(q, k, v, causal=causal, window=window)
    return h + o.reshape(*o.shape[:2], -1) @ ap["wo"]


def _ffn(lp, h, cfg: ModelConfig):
    """Pre-norm MLP or MoE with its residual: ``(h, aux_loss)``; under an
    active :func:`~repro_torch.models.parallel.parallel_ctx` the MoE is
    the expert-parallel block and the MLP the tensor-parallel one."""
    hn = _norm(cfg, lp["ln2"], h)
    ctx = parallel_ctx()
    if "moe" in lp:
        if ctx.ep and ctx.ep_comm is not None:
            out, aux = M.moe_block_ep(lp["moe"], hn, cfg, comm=ctx.ep_comm,
                                      ep_blocks=ctx.ep_blocks)
        else:
            out, aux = M.moe_block(lp["moe"], hn, cfg)
        return h + out, aux
    if ctx.tp > 1 and ctx.tp_comm is not None:
        return h + L.mlp_tp(lp["mlp"], hn, cfg, comm=ctx.tp_comm), 0.0
    return h + L.mlp(lp["mlp"], hn, cfg), 0.0


def _dense_block(lp, h, cfg: ModelConfig, *, positions, enc_out=None):
    """Causal self-attention, cross-attention to ``enc_out`` where the
    layer has it, then the MLP or MoE: ``(h, aux_loss)``."""
    h = _attn_noncache(lp, h, cfg, causal=True, positions=positions,
                       window=cfg.sliding_window)
    if enc_out is not None and "xattn" in lp:
        h = _attn_noncache(lp, h, cfg, causal=False, positions=positions,
                           window=0, kv=_cross_kv(lp["xattn"], enc_out, cfg))
    return _ffn(lp, h, cfg)


def _cross_kv(ap, enc_out, cfg: ModelConfig):
    """Cross-attention K, V of the encoder output: (B, Te, K, hd) each."""
    Bz, Te, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.hd()
    k = (enc_out @ ap["wk"]).reshape(Bz, Te, K, hd)
    v = (enc_out @ ap["wv"]).reshape(Bz, Te, K, hd)
    if "bk" in ap:
        k = k + ap["bk"].reshape(K, hd)
        v = v + ap["bv"].reshape(K, hd)
    return k, v


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


# ---------------------------------------------------------------------------
# no-cache forward (the consistency checks' reference for the cached path)
# ---------------------------------------------------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """``repro``'s ``checkpoint_dots_with_no_batch_dims`` as a selective
    checkpoint policy: keep the outputs of the products with no batch
    dimensions (``aten.mm`` / ``aten.addmm``, which every projection
    lowers to), recompute everything else in the backward, batched
    products (``aten.bmm``) and the kernels' autograd Functions
    included."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_runner(remat: str):
    """``run(fn, *args)`` that calls one layer: directly (``"none"``), or
    under ``torch.utils.checkpoint``, the counterpart of ``repro``'s
    ``_maybe_remat``: ``"full"`` keeps only the layer's inputs and runs it
    again in the backward; ``"dots"`` keeps the outputs of its products
    with no batch dimensions too (``_save_dots``) and recomputes the
    rest.  The forward draws no random numbers, so no RNG state is kept
    for the recompute; it runs under the parallel context of the forward
    (``parallel.bound``)."""
    if remat == "none":
        return lambda fn, *args: fn(*args)
    if remat == "full":
        return lambda fn, *args: checkpoint(bound(fn), *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
    if remat == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda fn, *args: checkpoint(bound(fn), *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False,
                                            context_fn=ctx)
    raise ValueError(f"unknown remat policy {remat!r}; have 'none', "
                     f"'full', 'dots'")


def _encoder_layer(lp, h, cfg: ModelConfig, positions):
    h = _attn_noncache(lp, h, cfg, causal=False, positions=positions,
                       window=0)
    return _ffn(lp, h, cfg)[0]


def _encoder_forward(params, cfg: ModelConfig, frames, remat: str = "none"):
    """Whisper encoder over frame embeddings (B, Te, d): learned positions
    and rotary, bidirectional attention (through K1 on the card)."""
    run = _layer_runner(remat)
    enc = params["encoder"]
    Te = frames.shape[1]
    h = (frames.float() + enc["pos"][:Te].float()).to(enc["pos"].dtype)
    positions = torch.arange(Te, device=h.device)[None]
    layer = functools.partial(_encoder_layer, cfg=cfg, positions=positions)
    for lp in enc["blocks"]:
        h = run(layer, lp, h)
    return _norm(cfg, enc["final_norm"], h)


def _embed_inputs(params, cfg: ModelConfig, tokens, extra_embeds):
    """Token embeds, with the vlm patch prefix in front.  The projection of
    the patches runs in f32 and is then cast, as ``repro``'s f32 patches
    against bf16 weights promote."""
    h = L.embed(params["embed"], tokens)
    if cfg.family == "vlm":
        if extra_embeds is None:
            raise ValueError("vlm needs patch embeddings")
        vis = extra_embeds.float() @ params["vis_proj"].float()
        h = torch.cat([vis.to(h.dtype), h], dim=1)
    return h


def _encode(params, cfg: ModelConfig, tokens, extra_embeds,
            remat: str = "none"):
    """(decoder input h, encoder output or None) for every family."""
    if cfg.family != "audio":
        return _embed_inputs(params, cfg, tokens, extra_embeds), None
    if extra_embeds is None:
        raise ValueError("audio needs frame embeddings")
    return (L.embed(params["embed"], tokens),
            _encoder_forward(params, cfg, extra_embeds, remat))


def model_forward(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
                  remat: str = "none"):
    """Full forward to logits.  tokens: (B, T) int; ``extra_embeds``: the
    vlm patches (B, vision_tokens, d) or the audio frames (B, Te, d).
    ``remat``: ``"none"``, ``"full"`` to recompute every layer (each
    Mamba2 layer, each use of the hybrid's shared block, each encoder
    layer) in the backward, or ``"dots"`` to recompute all of each layer
    but its products with no batch dimensions (``_save_dots``).
    Returns ``(logits (B, T_total, V), aux_loss)``: T_total counts the vlm
    prefix, and the aux loss (moe only, else 0) is summed over layers."""
    run = _layer_runner(remat)
    h, enc_out = _encode(params, cfg, tokens, extra_embeds, remat)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    block = functools.partial(_dense_block, cfg=cfg, positions=positions)
    if isinstance(params["blocks"], ShardedStack):
        # ZeRO-3: one code path for every family, its registered body
        # under scan_stack's gather (models/blockstack.py)
        body = block_stack_spec(cfg).make_body(
            cfg, params, positions=positions, enc_out=enc_out, remat=remat)
        h, aux_ys = scan_stack(params["blocks"], h, body)
        aux_total = aux_ys.sum()
    elif cfg.family in _SCANNED_FAMILIES:
        block = functools.partial(block, enc_out=enc_out)
        for lp in params["blocks"]:
            h, aux = run(block, lp, h)
            aux_total = aux_total + aux
    else:
        mamba = functools.partial(_mamba_block, cfg=cfg)
        for i, lp in enumerate(params["blocks"]):
            if _shared_attn_group(cfg, i) is not None:
                h, _ = run(block, params["shared_attn"], h)
            h, _ = run(mamba, lp, h)
    h = _norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], h), aux_total


# ---------------------------------------------------------------------------
# block-stack specs: how each family rides the ZeRO-3 sharded stack
# ---------------------------------------------------------------------------

def _scanned_stack_body(cfg, params, *, positions, enc_out, remat):
    """Per-layer body of the attention families: the replicated layer
    loop's block, with its remat.

    Under expert-parallel ``lane_zero3`` the expert weights live outside
    the flat stack, in the never-gathered local experts
    (``ParallelContext.ep_experts``, one dict of (E/p, ...) f32 leaves per
    layer): layer i's are cast to the model's dtype and put in
    ``lp["moe"]``, so the block itself is unchanged."""
    run = _layer_runner(remat)
    block = functools.partial(_dense_block, cfg=cfg, positions=positions,
                              enc_out=enc_out)
    dt = L.torch_dtype(cfg)

    def body(h, lp, i):
        experts = parallel_ctx().ep_experts
        if experts is not None and "moe" in lp:
            lp = {**lp, "moe": {**lp["moe"], **{
                k: v.to(dt) for k, v in experts[i].items()}}}
        return run(block, lp, h)
    return body


def _ssm_stack_body(cfg, params, *, positions, enc_out, remat):
    """The Mamba2 block as the sharded layer unit."""
    run = _layer_runner(remat)
    mamba = functools.partial(_mamba_block, cfg=cfg)

    def body(h, lp, i):
        return run(mamba, lp, h)[0], 0.0
    return body


def _hybrid_stack_body(cfg, params, *, positions, enc_out, remat):
    """Zamba2 as a flat per-layer loop: the weight-SHARED attention block
    (replicated, not gathered) runs before Mamba2 layer i exactly when i
    opens a group, as in the replicated forward."""
    run = _layer_runner(remat)
    block = functools.partial(_dense_block, cfg=cfg, positions=positions)
    mamba = functools.partial(_mamba_block, cfg=cfg)
    shared = params["shared_attn"]

    def body(h, lp, i):
        if _shared_attn_group(cfg, i) is not None:
            h, _ = run(block, shared, h)
        return run(mamba, lp, h)[0], 0.0
    return body


@register_block_stack("dense")
@register_block_stack("vlm")
@register_block_stack("audio")
def _block_stack_attn(cfg: ModelConfig) -> BlockSpec:
    """The attention families: the layer stack is the sharding unit;
    embed/final_norm (+ vis_proj / encoder) ride as the extras.  vlm and
    audio need patches / frames the training driver does not make."""
    return BlockSpec(family=cfg.family, make_body=_scanned_stack_body,
                     needs_extra_embeds=cfg.family in ("vlm", "audio"))


@register_block_stack("moe")
def _block_stack_moe(cfg: ModelConfig) -> BlockSpec:
    """MoE: the same skeleton; the 1/p stripes slice through the experts,
    or, expert-parallel, the experts stay out of the stack
    (``launch.steps.split_expert_stack``)."""
    return BlockSpec(family="moe", make_body=_scanned_stack_body)


@register_block_stack("ssm")
def _block_stack_ssm(cfg: ModelConfig) -> BlockSpec:
    return BlockSpec(family="ssm", make_body=_ssm_stack_body)


@register_block_stack("hybrid")
def _block_stack_hybrid(cfg: ModelConfig) -> BlockSpec:
    """The Mamba2 backbone sharded 1/p; the shared attention block stays
    replicated and syncs through the bucketed lane path."""
    return BlockSpec(family="hybrid", make_body=_hybrid_stack_body,
                     replicated_keys=("shared_attn",))


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def loss_fn(params, cfg: ModelConfig, tokens, labels, *, extra_embeds=None,
            remat: str = "none", aux_weight: float = 0.01):
    """Next-token cross-entropy in f32, mean over the labels >= 0 (-100
    masks a position), plus ``aux_weight`` times the moe aux loss.  The vlm
    prefix's logits are cut off: the loss is over the text positions.
    ``repro`` picks the gold logit by a one-hot sum over the vocabulary,
    for its sharding; a gather reads the same single value."""
    logits, aux = model_forward(params, cfg, tokens,
                                extra_embeds=extra_embeds, remat=remat)
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logits = logits.float()
    mask = (labels >= 0).float()
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = (torch.logsumexp(logits, dim=-1) - gold) * mask
    loss = ce.sum() / mask.sum().clamp_min(1.0)
    return loss + aux_weight * aux


def make_train_step(cfg: ModelConfig, *, remat: str = "none"):
    """``step(params, tokens, labels, extra_embeds=None) -> loss``, as
    ``repro``'s step factory; the launch layer differentiates it."""
    def step(params, tokens, labels, extra_embeds=None):
        return loss_fn(params, cfg, tokens, labels,
                       extra_embeds=extra_embeds, remat=remat)
    return step


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeState:
    """Serving state.  ``cache``: the family's stacked cache (module
    docstring), written in place by ``prefill`` and ``decode_step``;
    ``length``: (B,) int32 count of positions consumed per row (the vlm
    prefix included); ``enc_kv``: audio only, every decoder layer's cross
    K/V ``{"k", "v"}`` of shape (L, B, Te, K, hd), else None."""
    cache: dict
    length: torch.Tensor
    enc_kv: Optional[dict] = None


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

    if cfg.family in _SCANNED_FAMILIES:
        return kv(cfg.num_layers)
    mamba = {name: torch.zeros((cfg.num_layers, *a.shape), dtype=a.dtype,
                               device=dev)
             for name, a in S.init_mamba_state(cfg, batch,
                                               device="meta").items()}
    if cfg.family == "ssm":
        return mamba
    return {"mamba": mamba, "attn": kv(_hybrid_split(cfg)[0])}


def _attn_cached(lp, h, cfg: ModelConfig, kc, vc, length, *,
                 prefill: bool, enc_kv=None):
    """Attention with cache read and write, then the layer's
    cross-attention to ``enc_kv`` (this layer's (k, v), audio) and its
    MLP or MoE.  h: (B, T, d); kc, vc: this layer's (B, S, K, hd) cache,
    written in place.

    prefill: writes positions [0, T) and attends within the new block
             (through K1 on the card), and to all of ``enc_kv`` (K1,
             non-causal).
    decode:  T == 1; writes row b at position ``length[b]`` in place (a
             row whose length has reached S is left as it is, as in
             ``repro``) and attends to ``length + 1`` positions, and to
             all of ``enc_kv`` (plain decode attention).
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
    if enc_kv is not None:
        ek, ev = enc_kv
        hn = _norm(cfg, lp["lnx"], h)
        qx, _, _ = A.qkv(lp["xattn"], hn, cfg, positions=positions,
                         rope=False)
        o = A.attention(qx, ek, ev, causal=False) if prefill else \
            A.decode_attention(qx, ek, ev, ek.shape[1])
        h = h + o.reshape(Bz, T, -1) @ lp["xattn"]["wo"]
    h, _ = _ffn(lp, h, cfg)
    return h


def _mamba_cached(lp, h, cfg: ModelConfig, layer: dict):
    """Mamba2 block from one layer's state ``layer`` (views into the
    stacked cache), whose leaves it then overwrites in place."""
    h, new = _mamba_block(lp, h, cfg, state=layer)
    for name, a in layer.items():
        a.copy_(new[name])
    return h


def _layers_cached(params, cfg: ModelConfig, h, cache, length, *,
                   prefill: bool, enc_out=None, enc_kv=None):
    """Every layer of the family against its cache, in place.

    ``params["blocks"]`` is the list of layers, or a ``ShardedStack``
    (``lane_zero3`` serving: each layer's weights gathered one ahead);
    the dense, moe, ssm, vlm and audio families run through
    ``scan_stack_cached`` either way, so one body serves both hostings.
    Returns ``(h, enc_kv)``: given ``enc_out`` (the audio prefill), every
    layer's cross K/V computed in its body, stacked ``{"k", "v"}`` (L, B,
    Te, K, hd); else None."""
    stack = params["blocks"]
    if cfg.family in _SCANNED_FAMILIES:
        if enc_out is not None:
            def body(h, lp, x):
                k, v = _cross_kv(lp["xattn"], enc_out, cfg)
                return _attn_cached(lp, h, cfg, x[0], x[1], length,
                                    prefill=prefill, enc_kv=(k, v)), \
                    {"k": k, "v": v}
            return scan_stack_cached(stack, h, (cache["k"], cache["v"]),
                                     body)
        xs = (cache["k"], cache["v"]) if enc_kv is None else \
            (cache["k"], cache["v"], enc_kv["k"], enc_kv["v"])

        def body(h, lp, x):
            return _attn_cached(lp, h, cfg, x[0], x[1], length,
                                prefill=prefill,
                                enc_kv=None if len(x) == 2 else x[2:]), None
        return scan_stack_cached(stack, h, xs, body)[0], None
    if cfg.family == "ssm":
        def body(h, lp, layer):
            return _mamba_cached(lp, h, cfg, layer), None
        return scan_stack_cached(stack, h, cache, body)[0], None
    if isinstance(stack, ShardedStack):
        raise ValueError(
            f"family {cfg.family!r} cannot serve from a ShardedStack (the "
            f"hybrid grouped attention cache does not fit the flat layer "
            f"scan); host it replicated")
    mcache = cache["mamba"]
    for i, lp in enumerate(stack):
        g = _shared_attn_group(cfg, i)
        if g is not None:
            h = _attn_cached(params["shared_attn"], h, cfg,
                             cache["attn"]["k"][g], cache["attn"]["v"][g],
                             length, prefill=prefill)
        h = _mamba_cached(lp, h, cfg,
                          {name: a[i] for name, a in mcache.items()})
    return h, None


def _select_row(h, pos):
    """(B, T, d) -> (B, 1, d): row ``pos[b]`` of each batch element."""
    return h[torch.arange(h.shape[0], device=h.device), pos][:, None]


def prefill(params, cfg: ModelConfig, tokens, cache, *, extra_embeds=None,
            true_len=None):
    """Run the prompt and fill ``cache`` in place.  Returns
    ``(logits (B, 1, V), ServeState)``.

    ``extra_embeds``: the vlm patches, which go in front of the tokens as
    a prefix of ``vision_tokens`` positions, or the audio frames, whose
    encoder output gives the state's ``enc_kv``.

    ``true_len`` (int or (B,) ints) marks the valid prompt length when
    ``tokens`` is right-padded to a bucket: the logits are taken at the
    last true position (``prefix + true_len - 1``) and ``state.length`` is
    ``prefix + true_len``, so decode overwrites the pad region and
    attention never reads past it.  The recurrent families (ssm, hybrid)
    fold every token they are given into their state, so their callers
    prefill at the exact prompt length (the engine does).

    ``params["blocks"]`` may be a ``ShardedStack`` (``lane_zero3``
    serving; the dense, moe, ssm, vlm and audio families): the layers run
    through ``scan_stack_cached`` with the training's one-layer prefetch,
    and the audio cross K/V come from each layer's gathered weights.
    """
    h, enc_out = _encode(params, cfg, tokens, extra_embeds)
    Bz, T, _ = h.shape
    length0 = torch.zeros((Bz,), dtype=torch.int32, device=h.device)
    h, enc_kv = _layers_cached(params, cfg, h, cache, length0, prefill=True,
                               enc_out=enc_out)
    prefix = T - tokens.shape[1]            # vlm vision tokens, else 0
    if true_len is None:
        h_last = h[:, -1:]
        length = torch.full((Bz,), T, dtype=torch.int32, device=h.device)
    else:
        length = prefix + torch.as_tensor(
            true_len, dtype=torch.int32, device=h.device).expand(Bz).clone()
        h_last = _select_row(h, length.long() - 1)
    h_last = _norm(cfg, params["final_norm"], h_last)
    logits = L.unembed(params["embed"], h_last)
    return logits, ServeState(cache=cache, length=length, enc_kv=enc_kv)


def decode_step(params, cfg: ModelConfig, token, state: ServeState):
    """One token for every row.  token: (B, 1) int.  Writes the cache in
    place; the returned state shares it (and ``enc_kv``) and has
    ``length + 1``.  ``params["blocks"]`` may be a ``ShardedStack``, as
    in ``prefill``: layer i+1's gather then runs beside layer i's
    cached step."""
    h = L.embed(params["embed"], token)
    h, _ = _layers_cached(params, cfg, h, state.cache, state.length,
                          prefill=False, enc_kv=state.enc_kv)
    h = _norm(cfg, params["final_norm"], h)
    logits = L.unembed(params["embed"], h)
    return logits, ServeState(cache=state.cache, length=state.length + 1,
                              enc_kv=state.enc_kv)
