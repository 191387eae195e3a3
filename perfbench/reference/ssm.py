"""Plain reference of the ``ssm`` family (mamba2-780m as the program runs
it): pre-norm Mamba2 blocks over a tied embedding, and the next-token
cross-entropy.

A block, written out plainly: separate projections z, x, B, C and dt of
the normed input; a causal depthwise convolution (width ``d_conv``, with
bias) and SiLU over each of x, B and C; dt = softplus(dt + dt_bias),
A = -exp(A_log); the SSD recurrence state_t = exp(dt_t A) state_{t-1} +
dt_t x_t B_t^T, y_t = state_t C_t (one group of B and C for every head),
computed in its chunked dual form (``ssd``); y + D x; RMSNorm of
y · SiLU(z); the output projection; the residual.

The configuration's keys are those of the ``mamba_ssm`` package's
``config.json`` (``d_model``, ``n_layer``, ...), with the ``Mamba2``
module's own sizes (``d_state``, ``headdim``, ``expand``, ``d_conv``,
``ngroups``, ``chunk_size``) beside them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import cross_entropy, rmsnorm


def _sizes(cfg: dict):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return d, di, di // cfg["headdim"], cfg["headdim"], cfg["d_state"], \
        cfg["ngroups"], cfg["d_conv"]


def dims(cfg: dict) -> dict:
    d, di, H, P, S, G, W = _sizes(cfg)
    layer = d * (2 * di + 2 * G * S + H) + W * (di + 2 * G * S) + di * d
    return {"layers": cfg["n_layer"], "d_model": d,
            "vocab": cfg["vocab_size"], "layer_params_active": layer,
            "ssd_layers": cfg["n_layer"], "ssd_heads": H, "ssd_head_dim": P,
            "ssd_state": S, "ssd_chunk": cfg["chunk_size"]}


def check(cfg: dict) -> None:
    """Refuse a configuration whose keys this reference does not model."""
    if cfg["ngroups"] != 1 or cfg.get("d_intermediate", 0) \
            or not cfg["tie_embeddings"] or cfg.get("attn_layer_idx"):
        raise ValueError("only one B/C group, no MLP, no attention layers "
                         "and a tied embedding are modelled")


def param_specs(cfg: dict) -> list:
    d, di, H, P, S, G, W = _sizes(cfg)
    dt, std = cfg["torch_dtype"], cfg["initializer_range"]
    f32 = "float32"
    n = ("normal", std)
    conv = ("normal", cfg["conv_init_std"])
    specs = [("embed.tok", (cfg["vocab_size"], d), dt, n),
             ("final_norm.scale", (d,), dt, ("ones",))]
    for i in range(cfg["n_layer"]):
        p = f"blocks.{i}."
        m = p + "mamba."
        specs += [(p + "ln1.scale", (d,), dt, ("ones",)),
                  (m + "w_z", (d, di), dt, n),
                  (m + "w_x", (d, di), dt, n),
                  (m + "w_B", (d, G * S), dt, n),
                  (m + "w_C", (d, G * S), dt, n),
                  (m + "w_dt", (d, H), dt, n),
                  (m + "conv_x_w", (W, di), dt, conv),
                  (m + "conv_x_b", (di,), dt, ("zeros",)),
                  (m + "conv_B_w", (W, G * S), dt, conv),
                  (m + "conv_B_b", (G * S,), dt, ("zeros",)),
                  (m + "conv_C_w", (W, G * S), dt, conv),
                  (m + "conv_C_b", (G * S,), dt, ("zeros",)),
                  (m + "A_log", (H,), f32,
                   ("log_uniform", *cfg["A_init_range"])),
                  (m + "D", (H,), f32, ("ones",)),
                  (m + "dt_bias", (H,), f32,
                   ("dt_bias", cfg["dt_min"], cfg["dt_max"])),
                  (m + "norm.scale", (di,), dt, ("ones",)),
                  (m + "out_proj", (di, d), dt, n)]
    return specs


LAYER_KEYS = ("ln1.scale", "mamba.w_z", "mamba.w_x", "mamba.w_B",
              "mamba.w_C", "mamba.w_dt", "mamba.conv_x_w", "mamba.conv_x_b",
              "mamba.conv_B_w", "mamba.conv_B_b", "mamba.conv_C_w",
              "mamba.conv_C_b", "mamba.A_log", "mamba.D", "mamba.dt_bias",
              "mamba.norm.scale", "mamba.out_proj")


def causal_conv(x, w, b):
    """Depthwise causal convolution: out_t = b + sum_i w_i x_{t+i-(W-1)}.
    x: (B, T, C); w: (W, C)."""
    W, T = w.shape[0], x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.T[:, None, :], b, padding=W - 1,
                 groups=x.shape[2])
    return y[..., :T].transpose(1, 2)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD recurrence in its chunked dual form.  x: (b, T, H, P); dt:
    (b, T, H); A: (H,); B, C: (b, T, S).  Returns y (b, T, H, P)."""
    b, T0, H, P = x.shape
    Q = min(chunk, T0)
    pad = -T0 % Q
    if pad:
        x, dt, B, C = (F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
                       for t in (x, dt, B, C))
    T = T0 + pad
    nc = T // Q
    xd = (x * dt[..., None]).reshape(b, nc, Q, H, P)
    a = (dt * A).reshape(b, nc, Q, H).permute(0, 3, 1, 2)    # (b,H,nc,Q)
    acs = a.cumsum(-1)
    Bc, Cc = B.reshape(b, nc, Q, -1), C.reshape(b, nc, Q, -1)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(~causal,
                                                              float("-inf"))
    mix = torch.exp(seg) * torch.einsum("bcls,bcms->bclm", Cc, Bc)[:, None]
    y = torch.einsum("bhclm,bcmhp->bclhp", mix, xd)
    to_end = torch.exp(acs[..., -1:] - acs)                   # (b,H,nc,Q)
    states = torch.einsum("bcms,bcmhp->bchps", Bc,
                          xd * to_end.permute(0, 2, 3, 1)[..., None])
    decay = torch.exp(acs[..., -1])                           # (b,H,nc)
    state = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(state)
        state = state * decay[:, :, c, None, None] + states[:, c]
    before = torch.stack(before, dim=1)                       # (b,nc,H,P,S)
    y = y + torch.einsum("bcls,bchps->bclhp", Cc, before) \
        * torch.exp(acs).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, T, H, P)[:, :T0]


def _layer(cfg, prec, h, ln1, w_z, w_x, w_B, w_C, w_dt, cxw, cxb, cBw, cBb,
           cCw, cCb, A_log, D, dt_bias, norm, out_proj):
    B, T, _ = h.shape
    d, di, H, P, S, G, W = _sizes(cfg)
    eps = cfg["norm_eps"]
    x = rmsnorm(h, ln1, eps)
    z = prec.mm(x, w_z)
    xs = F.silu(causal_conv(prec.mm(x, w_x), cxw, cxb))
    Bp = F.silu(causal_conv(prec.mm(x, w_B), cBw, cBb))
    Cp = F.silu(causal_conv(prec.mm(x, w_C), cCw, cCb))
    dt = F.softplus(prec.mm(x, w_dt) + dt_bias)
    xs = xs.reshape(B, T, H, P)
    y = ssd(xs, dt, -torch.exp(A_log), Bp, Cp, cfg["chunk_size"])
    y = (y + xs * D[:, None]).reshape(B, T, di)
    y = rmsnorm(y * F.silu(z), norm, eps)
    return h + prec.mm(y, out_proj)


def loss(params: dict, cfg: dict, tokens, labels, prec, *, layer_call):
    """Mean next-token cross-entropy."""
    h = params["embed.tok"][tokens]
    for i in range(cfg["n_layer"]):
        ps = [params[f"blocks.{i}.{key}"] for key in LAYER_KEYS]
        h = layer_call(lambda *a: _layer(cfg, prec, *a), h, *ps)
    h = rmsnorm(h, params["final_norm.scale"], cfg["norm_eps"])
    return cross_entropy(prec.mm(h, params["embed.tok"].T), labels)
