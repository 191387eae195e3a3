"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref``, plus the port of ``repro``'s lax
SSD scan (``repro.models.ssm.ssd_chunked``):

* ``attention_ref``   — the plain version of K1
                        (``kernels/flash_attention.py``), with its mask
                        ``attention_mask``;
* ``ssd_chunked``     — the chunked SSD scan in ``repro``'s model layout,
                        re-exported by ``models.ssm``;
* ``ssd_chunked_ref`` — the same in K2's head-major layout: the plain
                        version of K2 (``kernels/ssd.py``);
* ``ssd_ref``         — the sequential SSD recurrence, the definitional
                        oracle of both.

A plain version is the CPU path of ``kernels.ops`` and the yardstick its
kernel is held to on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_mask(Tq: int, Tk: int, *, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(Tq, Tk) bool, True where query position q may see key position k:
    ``q >= k`` if causal, ``k >= q - window`` if a window is set."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos >= qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive softmax attention.  q: (B,H,Tq,hd); k,v: (B,K,Tk,hd)."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(hd), kf)
    mask = attention_mask(Tq, Tk, causal=causal, window=window,
                          device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)


def ssd_ref(x, dt, A, B, C):
    """Sequential SSD recurrence (the definitionally correct form).

    x: (b,H,T,P); dt: (b,H,T); A: (H,); B,C: (b,T,S).  Returns (b,H,T,P).
    state_t = e^{dt_t A} state_{t-1} + dt_t x_t (x) B_t;  y_t = C_t . state_t
    Computed in f32, or in f64 for f64 inputs (the tests' oracle of the
    scan's gradient).
    """
    b, H, T, P = x.shape
    S = B.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)   # f32, or f64
    xf, dtf, Bf, Cf = (t.to(acc) for t in (x, dt, B, C))
    state = torch.zeros((b, H, P, S), dtype=acc, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, :, t] * A[None, :])
        state = (state * decay[..., None, None]
                 + torch.einsum("bh,bhp,bs->bhps", dtf[:, :, t], xf[:, :, t],
                                Bf[:, t]))
        ys.append(torch.einsum("bs,bhps->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=2).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, *, chunk: int, init_state=None):
    """SSD dual-form mixing, chunk by chunk.

    x:  (b, T, H, P)   per-head values
    dt: (b, T, H)      positive step sizes (already softplus'd + biased)
    A:  (H,)           negative decay rates (= -exp(A_log))
    B, C: (b, T, G, S) input/output projections (G groups broadcast to H)
    Returns (y (b,T,H,P), final_state (b,H,P,S) f32).  A ragged tail is
    padded with dt = 0, which leaves the state as it is.
    """
    b, T, H, P = x.shape
    G, S = B.shape[2], B.shape[3]
    Q = min(chunk, T)
    T0 = T
    if T % Q:
        pad = Q - T % Q
        x, dt, B, C = (F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
                       for a in (x, dt, B, C))
        T = T + pad
    nc = T // Q
    rep = H // G

    xc = x.float().reshape(b, nc, Q, H, P)
    dtc = dt.float().reshape(b, nc, Q, H)
    Bc = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, H, S)
    Cc = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, H, S)

    da = dtc * A[None, None, None, :]                  # (b,nc,Q,H) <= 0
    cum = torch.cumsum(da, dim=2)                      # within-chunk
    seg_end = cum[:, :, -1, :]                         # (b,nc,H)

    # intra-chunk: L[q1,q2] = exp(cum[q1] - cum[q2]) for q1 >= q2, else 0.
    # Masked before the exponential: above the diagonal diff > 0, and
    # exp(diff) overflows once dt|A|(Q-1) passes ~88.7; selecting 0 after
    # it keeps the value but makes the gradient 0 * inf = NaN (repro's
    # ssd_chunked does that).  exp(-inf) = 0 gives both right.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bcqhs,bckhs->bcqkh", Cc, Bc) * Lmat
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", scores, dtc, xc)

    # chunk summaries and the inter-chunk recurrence
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cum)     # (b,nc,Q,H)
    chunk_state = torch.einsum("bcqhs,bcqh,bcqh,bcqhp->bchps",
                               Bc, dtc, decay_to_end, xc)      # (b,nc,H,P,S)
    state = torch.zeros((b, H, P, S), dtype=torch.float32,
                        device=x.device) if init_state is None \
        else init_state.float()
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * torch.exp(seg_end[:, c])[:, :, None, None] \
            + chunk_state[:, c]
    prev_states = torch.stack(prevs, dim=1)                    # (b,nc,H,P,S)
    y_inter = torch.einsum("bcqhs,bchps->bcqhp",
                           Cc * torch.exp(cum)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(b, T, H, P)[:, :T0]
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, A, B, C, *, chunk: int, init_state=None):
    """``ssd_chunked`` in K2's head-major layout, one group.  x: (b,H,T,P);
    dt: (b,H,T); A: (H,); B,C: (b,T,S); init_state: None or (b,H,P,S).
    Returns (y (b,H,T,P), final_state (b,H,P,S) f32)."""
    y, final = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A,
                           B[:, :, None], C[:, :, None], chunk=chunk,
                           init_state=init_state)
    return y.transpose(1, 2), final
