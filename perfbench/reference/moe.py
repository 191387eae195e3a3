"""Plain reference of the ``moe`` family (granite-moe-3b-a800m as the
program runs it): pre-norm blocks of grouped-query causal attention with
rotary positions and a token-choice top-k mixture of experts with a
capacity, RMSNorm, an untied or tied unembedding, and the next-token
cross-entropy plus the router's load-balancing loss.

The routing, written out plainly: a softmax over the router's logits;
the k most probable experts (ties to the lower index), their
probabilities renormalised to sum to one; within each batch row, the
assignments (token, choice) in order, each expert keeps its first C,
C = max(8, ceil8(int(capacity_factor·k·T / E))), and a dropped
assignment adds nothing.  The load-balancing loss is E · Σ_e f_e · P_e
(f_e the share of the row's assignments that chose e, P_e its mean
probability), averaged over the rows and summed over the layers.

The configuration's keys are Hugging Face's (``hidden_size``,
``num_local_experts``, ...); a key the program does not model
(``embedding_multiplier``, ``attention_multiplier``,
``residual_multiplier``, ``logits_scaling``) must be at its neutral
value, ``attention_multiplier`` at 1/sqrt(head_dim).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import (causal_attention, cross_entropy,
                                        rmsnorm, rope)


def dims(cfg: dict) -> dict:
    d, H, K = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    f, E, k = cfg["intermediate_size"], cfg["num_local_experts"], \
        cfg["num_experts_per_tok"]
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    return {"layers": cfg["num_hidden_layers"], "d_model": d,
            "vocab": cfg["vocab_size"], "heads": H, "kv_heads": K,
            "head_dim": hd, "attn_layers": cfg["num_hidden_layers"],
            "window": 0, "experts": E, "experts_per_token": k,
            "layer_params_active": attn + d * E + k * 3 * d * f}


def check(cfg: dict) -> None:
    """Refuse a configuration whose keys this reference does not model."""
    hd = cfg.get("head_dim") \
        or cfg["hidden_size"] // cfg["num_attention_heads"]
    neutral = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "logits_scaling": 1.0,
               "attention_multiplier": 1.0 / math.sqrt(hd)}
    for key, want in neutral.items():
        if not math.isclose(cfg.get(key, want), want, rel_tol=1e-9):
            raise ValueError(f"{key}={cfg[key]} is not modelled (want {want})")
    if cfg.get("attention_bias") or cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("only bias-free attention and a SiLU-gated expert "
                         "are modelled")


def param_specs(cfg: dict) -> list:
    """(name, shape, dtype, init) of every parameter, in the program's
    tree paths."""
    dm = dims(cfg)
    d, V, H, K, hd = dm["d_model"], dm["vocab"], dm["heads"], dm["kv_heads"], \
        dm["head_dim"]
    f, E = cfg["intermediate_size"], dm["experts"]
    dt, std = cfg["torch_dtype"], cfg["initializer_range"]
    n = ("normal", std)
    specs = [("embed.tok", (V, d), dt, n)]
    if not cfg["tie_word_embeddings"]:
        specs.append(("embed.head", (d, V), dt, n))
    specs.append(("final_norm.scale", (d,), dt, ("ones",)))
    for i in range(dm["layers"]):
        p = f"blocks.{i}."
        specs += [(p + "ln1.scale", (d,), dt, ("ones",)),
                  (p + "attn.wq", (d, H * hd), dt, n),
                  (p + "attn.wk", (d, K * hd), dt, n),
                  (p + "attn.wv", (d, K * hd), dt, n),
                  (p + "attn.wo", (H * hd, d), dt, n),
                  (p + "ln2.scale", (d,), dt, ("ones",)),
                  (p + "moe.router", (d, E), dt, n),
                  (p + "moe.w_up", (E, d, f), dt, n),
                  (p + "moe.w_gate", (E, d, f), dt, n),
                  (p + "moe.w_down", (E, f, d), dt, n)]
    return specs


LAYER_KEYS = ("ln1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
              "ln2.scale", "moe.router", "moe.w_up", "moe.w_gate",
              "moe.w_down")


def capacity(cfg: dict, T: int) -> int:
    c = int(cfg["moe_capacity_factor"] * cfg["num_experts_per_tok"] * T
            / cfg["num_local_experts"])
    return max(8, -(-c // 8) * 8)


def moe(x, router, w_up, w_gate, w_down, cfg, prec):
    """(out, load-balancing loss) of one layer's experts on x (B, T, d)."""
    B, T, d = x.shape
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    density = F.one_hot(top_e, E).float().mean(dim=(1, 2))
    aux = E * (density * probs.mean(dim=1)).sum(-1).mean()
    flat_e = top_e.reshape(B, T * k)
    seen = F.one_hot(flat_e, E).cumsum(dim=1)          # (B, T·k, E)
    rank = seen.gather(2, flat_e[..., None])[..., 0] - 1
    keep = rank < capacity(cfg, T)
    weight = top_p.reshape(B, T * k) * keep
    xf = x.reshape(B * T, d)
    out = torch.zeros_like(xf)
    for e in range(E):
        b, j = torch.nonzero((flat_e == e) & keep, as_tuple=True)
        rows = b * T + j // k
        xe = xf[rows]
        he = F.silu(prec.mm(xe, w_gate[e])) * prec.mm(xe, w_up[e])
        out = out.index_add(0, rows, prec.mm(he, w_down[e])
                            * weight[b, j][:, None])
    return out.reshape(B, T, d), aux


def _layer(cfg, prec, h, ln1, wq, wk, wv, wo, ln2, router, w_up, w_gate,
           w_down):
    B, T, d = h.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = rmsnorm(h, ln1, eps)
    q = rope(prec.mm(x, wq).reshape(B, T, H, hd), theta)
    kk = rope(prec.mm(x, wk).reshape(B, T, K, hd), theta)
    v = prec.mm(x, wv).reshape(B, T, K, hd)
    h = h + prec.mm(causal_attention(q, kk, v, prec), wo)
    out, aux = moe(rmsnorm(h, ln2, eps), router, w_up, w_gate, w_down, cfg,
                   prec)
    return h + out, aux


def loss(params: dict, cfg: dict, tokens, labels, prec, *, layer_call):
    """Mean cross-entropy plus ``router_aux_loss_coef`` times the summed
    load-balancing losses."""
    h = params["embed.tok"][tokens]
    aux_total = torch.zeros((), device=h.device)
    for i in range(cfg["num_hidden_layers"]):
        ps = [params[f"blocks.{i}.{key}"] for key in LAYER_KEYS]
        h, aux = layer_call(lambda *a: _layer(cfg, prec, *a), h, *ps)
        aux_total = aux_total + aux
    h = rmsnorm(h, params["final_norm.scale"], cfg["rms_norm_eps"])
    head = params["embed.tok"].T if cfg["tie_word_embeddings"] \
        else params["embed.head"]
    return cross_entropy(prec.mm(h, head), labels) \
        + cfg["router_aux_loss_coef"] * aux_total
