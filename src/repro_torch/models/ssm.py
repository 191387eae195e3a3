"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

Counterpart of ``repro.models.ssm``.  in_proj emits [z | x | B | C | dt]
as separate projections, a short depthwise conv runs over each of x, B
and C, then SSD mixing, a gated RMSNorm and out_proj.

The prefill and no-cache scan goes through ``kernels.ops.ssd``: K2 on a
CUDA tensor, on a CPU tensor its plain version, which is the port of
``repro``'s ``ssd_chunked`` (re-exported here).  ``repro``'s own model
path calls ``ssd_chunked`` directly, so on the CPU the two compute the
same function.  Decode advances an explicit (conv state, ssm state) pair
by one token in plain tensor code (``repro`` has no kernel for it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked
from .layers import dense_init, rmsnorm, torch_dtype

__all__ = ["init_mamba2", "ssd_chunked", "ssd_decode_step", "mamba2_block",
           "init_mamba_state"]


def init_mamba2(cfg: ModelConfig, *, generator, device) -> dict:
    """Separate projections (w_z/w_x/w_B/w_C/w_dt) and per-stream convs,
    as in ``repro``, with ``repro``'s distributions.  (``repro`` draws
    ``w_dt`` and ``out_proj`` from one key; here they are independent.)"""
    d, dt_ = cfg.d_model, torch_dtype(cfg)
    di, S, G, W = cfg.d_inner(), cfg.ssm_state, cfg.ssm_groups, \
        cfg.ssm_conv_width
    H = cfg.ssm_heads()
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if device.type == "meta":
        dt_bias = torch.empty((H,), **f32)
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand((H,), generator=generator, **f32) * (hi - lo) + lo
        dt_bias = torch.log(torch.expm1(torch.exp(u)))
    return {
        "w_z": dense_init((d, di), dt_, **kw),
        "w_x": dense_init((d, di), dt_, **kw),
        "w_B": dense_init((d, G * S), dt_, **kw),
        "w_C": dense_init((d, G * S), dt_, **kw),
        "w_dt": dense_init((d, H), dt_, **kw),
        "conv_x_w": dense_init((W, di), dt_, scale=0.5, **kw),
        "conv_x_b": torch.zeros((di,), dtype=dt_, device=device),
        "conv_B_w": dense_init((W, G * S), dt_, scale=0.5, **kw),
        "conv_B_b": torch.zeros((G * S,), dtype=dt_, device=device),
        "conv_C_w": dense_init((W, G * S), dt_, scale=0.5, **kw),
        "conv_C_b": torch.zeros((G * S,), dtype=dt_, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt_bias,
        "norm": {"scale": torch.ones((di,), dtype=dt_, device=device)},
        "out_proj": dense_init((di, d), dt_, **kw),
    }


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token SSD update.

    state: (b,H,P,S) f32; x_t: (b,H,P); dt_t: (b,H); B_t/C_t: (b,G,S).
    Returns (y_t (b,H,P) in x_t's dtype, new_state f32).
    """
    H, G = x_t.shape[1], B_t.shape[1]
    rep = H // G
    Bh = B_t.float().repeat_interleave(rep, dim=1)        # (b,H,S)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    da = dtf * A[None, :]                                 # (b,H)
    new_state = (state * torch.exp(da)[:, :, None, None]
                 + torch.einsum("bh,bhs,bhp->bhps", dtf, Bh, x_t.float()))
    y = torch.einsum("bhs,bhps->bhp", Ch, new_state)
    return y.to(x_t.dtype), new_state


def _conv1d(xBC, w, b, conv_state=None):
    """Depthwise causal conv, width W.  xBC: (B,T,C); w: (W,C).

    If conv_state (B, W-1, C) is given, it prefixes the sequence (decode
    or prefill continuation).  Returns (out, the last W-1 inputs), the
    latter reaching into conv_state when T < W-1.
    """
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)                   # (B, T+W-1, C)
    T = xBC.shape[1]
    out = full[:, 0:T] * w[0][None, None]
    for i in range(1, W):
        out = out + full[:, i:i + T] * w[i][None, None]
    new_state = full[:, -(W - 1):] if W > 1 else pad
    return out + b[None, None], new_state


def mamba2_block(p: dict, x, cfg: ModelConfig, *, state=None):
    """x: (B, T, d) -> ((B, T, d), new state).

    state None: no cache (the scan starts from zero; new state None).
    state {"conv_x", "conv_B", "conv_C", "ssm"}: T == 1 decodes one token,
    T > 1 prefills from it; either way the new state is returned.
    """
    Bsz, T, _ = x.shape
    H, P = cfg.ssm_heads(), cfg.ssm_head_dim
    G, S = cfg.ssm_groups, cfg.ssm_state
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bp = x @ p["w_B"]
    Cp = x @ p["w_C"]
    dt = x @ p["w_dt"]
    cs = state if state is not None else {}
    xs, new_cx = _conv1d(xs, p["conv_x_w"], p["conv_x_b"], cs.get("conv_x"))
    Bp, new_cB = _conv1d(Bp, p["conv_B_w"], p["conv_B_b"], cs.get("conv_B"))
    Cp, new_cC = _conv1d(Cp, p["conv_C_w"], p["conv_C_b"], cs.get("conv_C"))
    xs, Bp, Cp = F.silu(xs), F.silu(Bp), F.silu(Cp)
    xs = xs.reshape(Bsz, T, H, P)
    Bp = Bp.reshape(Bsz, T, G, S)
    Cp = Cp.reshape(Bsz, T, G, S)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])   # (B,T,H) f32
    A = -torch.exp(p["A_log"])

    if state is not None and T == 1:
        y1, new_ssm = ssd_decode_step(state["ssm"], xs[:, 0], dt[:, 0], A,
                                      Bp[:, 0], Cp[:, 0])
        y = y1[:, None]
    else:
        if G != 1:
            raise ValueError(f"the SSD scan takes one group; "
                             f"{cfg.name} has ssm_groups={G}")
        yh, new_ssm = ops.ssd(
            xs.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous(),
            A, Bp[:, :, 0].contiguous(), Cp[:, :, 0].contiguous(),
            chunk=cfg.ssm_chunk,
            init_state=None if state is None else state["ssm"].contiguous())
        y = yh.transpose(1, 2)
    new_state = None if state is None else {
        "conv_x": new_cx, "conv_B": new_cB, "conv_C": new_cC,
        "ssm": new_ssm}

    y = y + xs * p["D"][None, None, :, None]          # f32 D promotes...
    y = y.reshape(Bsz, T, cfg.d_inner()).to(x.dtype)  # ...cast back
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], new_state


def init_mamba_state(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32) -> dict:
    di, S, G, W = cfg.d_inner(), cfg.ssm_state, cfg.ssm_groups, \
        cfg.ssm_conv_width
    H, P = cfg.ssm_heads(), cfg.ssm_head_dim
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return {"conv_x": z(batch, W - 1, di),
            "conv_B": z(batch, W - 1, G * S),
            "conv_C": z(batch, W - 1, G * S),
            "ssm": z(batch, H, P, S, dt=torch.float32)}
