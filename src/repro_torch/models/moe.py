"""Mixture-of-Experts layer: token-choice top-k routing, capacity dispatch.

Counterpart of ``repro.models.moe`` (``init_moe``, ``_route``,
``_capacity``, ``_dispatch_buffer``, ``_combine``, ``moe_block``, and the
expert-parallel ``moe_block_ep`` with ``_nested_fold`` and ``_ep_ffn``).

Dispatch is per batch row: each row's (token, k) assignments are ranked
within their expert, and an expert keeps the first ``C`` of them, with
``C = max(8, ceil8(int(capacity_factor · K · T / E)))`` for a row of
``T`` tokens (at prefill the bucket, pad tokens included).  Ranks come
from a stable sort of the flat (t, k) expert ids, so the earlier token
wins a slot and the pad tokens, which lie after the prompt, rank last.
An assignment past its expert's capacity goes to a trash slot ``E·C``
and contributes nothing.  The expert FFN is a batched product over the
(B, E, C, d) slot buffer, as in ``repro``, which computes it outside any
Pallas kernel; dispatch and combine are gathers and scatters.

While a profiler records, both blocks run under the ``repro_torch.obs``
span ``moe/forward`` and their backward under ``moe/backward``, and
``_dispatch_buffer`` counts ``moe.assigned`` (B·T·K) and ``moe.kept``
(the assignments within capacity).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from .layers import _act, dense_init, torch_dtype

__all__ = ["init_moe", "moe_block", "moe_block_ep"]


def init_moe(cfg: ModelConfig, *, generator, device) -> dict:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, torch_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init((d, E), dt, **kw),
         "w_up": dense_init((E, d, f), dt, **kw),
         "w_down": dense_init((E, f, d), dt, **kw)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((E, d, f), dt, **kw)
    return p


def _route(p, x, cfg: ModelConfig):
    """x: (B, T, d) → (probs (B,T,K), experts (B,T,K), aux_loss scalar)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = (x @ p["router"]).float()                   # product in x's dtype
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower expert index; torch.topk does
    # not promise an order among equals, a stable descending sort does
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss (Switch-style): E · Σ_e f_e · P_e
    density = F.one_hot(top_e, E).float().mean(dim=(1, 2))   # (B, E)
    p_mean = probs.mean(dim=1)                               # (B, E)
    aux = E * (density * p_mean).sum(-1).mean()
    return top_p, top_e, aux


def _capacity(cfg: ModelConfig, T: int) -> int:
    E, K = cfg.num_experts, cfg.experts_per_token
    c = int(cfg.moe_capacity_factor * K * T / E)
    return max(8, -(-c // 8) * 8)                        # round up to 8


def _dispatch_buffer(p: dict, x, cfg: ModelConfig):
    """Route, assign slots and scatter the tokens into the (B, E, C, d)
    buffer.  Returns ``(buf, slot, keep, top_p, aux, C)``; ``slot`` and
    ``keep`` are (B, T·K) in (t, k) order."""
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    top_p, top_e, aux = _route(p, x, cfg)

    # rank of each (t, k) within its expert: position in the stable sort
    # of the flat expert ids, less the number of earlier experts' entries
    TK = T * K
    flat_e = top_e.reshape(B, TK)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, sort_idx)
    hist = torch.zeros((B, E), dtype=flat_e.dtype, device=x.device)
    hist.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = hist.cumsum(1) - hist                        # exclusive prefix
    pos = torch.arange(TK, device=x.device).expand(B, TK)
    rank = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, pos - start.gather(1, sorted_e))    # back to (t, k) order
    keep = rank < C                                      # overflow dropped
    obs.count("moe.assigned", B * TK)
    obs.count("moe.kept", keep)
    slot = torch.where(keep, flat_e * C + rank, E * C)   # E*C = trash slot

    xe = x.repeat_interleave(K, dim=1) if K > 1 else x   # (B, TK, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None]
    # every kept slot is written once; the trash row takes every dropped
    # assignment, and which of them lands there is left open — it does not
    # matter, because that row is cut off here and never read
    buf[rows, slot] = xe
    return buf[:, :-1].reshape(B, E, C, d), slot, keep, top_p, aux, C


def _combine(y, slot, keep, top_p, x, cfg: ModelConfig):
    """Gather the expert outputs ``y`` (B, E, C, d) back to token order,
    weighted by the router's probability; a dropped assignment reads the
    zero row at the trash slot."""
    B, T, d = x.shape
    K = cfg.experts_per_token
    y = y.reshape(B, -1, d)
    y = torch.cat([y, y.new_zeros((B, 1, d))], dim=1)
    gathered = y[torch.arange(B, device=x.device)[:, None], slot]  # (B,TK,d)
    w = (top_p.reshape(B, T * K) * keep).to(x.dtype)
    return (gathered * w[..., None]).reshape(B, T, K, d).sum(dim=2)


def _spanned(block):
    """``block`` under ``moe/forward``, its backward under
    ``moe/backward`` (``obs.backward_span`` from its output to ``x``)."""
    @functools.wraps(block)
    def spanned(p, x, cfg, **kw):
        with obs.span("moe/forward"):
            x, close = obs.backward_span("moe/backward", x)
            out, aux = block(p, x, cfg, **kw)
            return close(out), aux
    return spanned


@_spanned
def moe_block(p: dict, x, cfg: ModelConfig):
    """Capacity-based dispatch; returns ``(out (B, T, d), aux_loss)``."""
    buf, slot, keep, top_p, aux, _ = _dispatch_buffer(p, x, cfg)
    h = torch.einsum("becd,edf->becf", buf, p["w_up"])
    if "w_gate" in p:
        h = _act(cfg.act)(torch.einsum("becd,edf->becf", buf,
                                       p["w_gate"])) * h
    else:
        h = _act(cfg.act)(h)
    y = torch.einsum("becf,efd->becd", h, p["w_down"])   # (B, E, C, d)
    return _combine(y, slot, keep, top_p, x, cfg), aux


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def _nested_fold(parts, n: int, N: int):
    """Sum per-source partials in the ``lane_zero3`` reduce-scatter's
    association: the gathered path's flat gradient sync is RS(node), then
    RS(lane), so per element an ascending fold over the node ranks inside
    each lane, then over the lanes.  ``parts`` is indexed by global rank
    s = lane·n + node."""
    lanes = []
    for l in range(N):
        a = parts[l * n]
        for j in range(1, n):
            a = a + parts[l * n + j]
        lanes.append(a)
    tot = lanes[0]
    for l in range(1, N):
        tot = tot + lanes[l]
    return tot


def _ep_ffn_out(act, z, w_up, w_gate, w_down):
    h = torch.einsum("sebcd,edf->sebcf", z, w_up)
    if w_gate is not None:
        h = _act(act)(torch.einsum("sebcd,edf->sebcf", z, w_gate)) * h
    else:
        h = _act(act)(h)
    return torch.einsum("sebcf,efd->sebcd", h, w_down)


class _EpFFN(torch.autograd.Function):
    """The local expert FFN over the received tokens of capacity block j,
    z: (s, e, b, c, d).

    The forward contracts over d and f only, so every output element is
    :func:`moe_block`'s.  The backward computes the weight gradients one
    partial product per source rank and folds them with
    :func:`_nested_fold`, the association in which the gathered path's
    per-process partials meet in the ``lane_zero3`` reduce-scatter (plain
    autograd would contract (s, b, c) in one product).  This is
    ``repro``'s ``_ep_ffn`` custom VJP.  ``blocks`` (a dict shared by the
    ``ep_blocks`` calls of one MoE block) holds each block's operands
    until the last block's backward, which takes every weight gradient
    over the whole capacity at once; the others give none.  So the
    weight gradients are rounded once, as with ``ep_blocks = 1``, not
    once per block and again in their sum (which parts the bf16 losses
    from step 2)."""

    @staticmethod
    def forward(ctx, z, w_up, w_gate, w_down, act, n, N, blocks, j):
        ctx.act, ctx.nN, ctx.blocks, ctx.j = act, (n, N), blocks, j
        ctx.save_for_backward(z, w_up, w_gate, w_down)
        return _ep_ffn_out(act, z, w_up, w_gate, w_down)

    @staticmethod
    def backward(ctx, dy):
        z, w_up, w_gate, w_down = ctx.saved_tensors
        act, (n, N) = ctx.act, ctx.nN
        fa = _act(act)
        with torch.enable_grad():
            h1 = torch.einsum("sebcd,edf->sebcf", z, w_up).detach() \
                .requires_grad_()
            if w_gate is None:
                a = fa(h1)
                ins = (h1,)
            else:
                hg = torch.einsum("sebcd,edf->sebcf", z, w_gate).detach() \
                    .requires_grad_()
                a = fa(hg) * h1
                ins = (h1, hg)
            da = torch.einsum("sebcd,efd->sebcf", dy, w_down)
            dh = torch.autograd.grad(a, ins, da)
        a = a.detach()
        dh1, dhg = dh[0], (dh[1] if w_gate is not None else None)
        dz = torch.einsum("sebcf,edf->sebcd", dh1, w_up)
        if w_gate is not None:
            dz = dz + torch.einsum("sebcf,edf->sebcd", dhg, w_gate)
        ops, k = ctx.blocks["ops"], ctx.blocks["k"]
        ops[ctx.j] = (z, dh1, dhg, a, dy)
        if len(ops) < k:
            return dz, None, None, None, None, None, None, None, None
        # every block's backward has run: the c axis whole again
        z, dh1, dhg, a, dy = [
            None if t[0] is None else torch.cat(t, dim=3)
            for t in zip(*(ops.pop(i) for i in range(k)))]

        def acc(u, v, spec):
            return _nested_fold([torch.einsum(spec, u[s], v[s])
                                 for s in range(n * N)], n, N)

        dw_up = acc(z, dh1, "ebcd,ebcf->edf")
        dw_gate = None if w_gate is None else acc(z, dhg, "ebcd,ebcf->edf")
        dw_down = acc(a, dy, "ebcf,ebcd->efd")
        return dz, dw_up, dw_gate, dw_down, None, None, None, None, None


class _Routed(torch.autograd.Function):
    """x -> its routed rows, the result of a ``moe_route`` started on it
    (``work``); backward: the cotangent routed back, synchronously (the
    all-to-all is its own transpose)."""

    @staticmethod
    def forward(ctx, x, work, comm, strategy):
        ctx.comm, ctx.strategy = comm, strategy
        return work.wait()

    @staticmethod
    def backward(ctx, dy):
        return ctx.comm.moe_route(dy.contiguous(), strategy=ctx.strategy), \
            None, None, None


def _route_start(comm, x, strategy):
    """Start routing ``x`` and return the call that waits for it, in the
    autograd graph."""
    work = comm.moe_route(x.detach(), strategy=strategy, async_op=True)
    return lambda: _Routed.apply(x, work, comm, strategy)


@_spanned
def moe_block_ep(p: dict, x, cfg: ModelConfig, *, comm, experts=None,
                 ep_blocks: int = 1, strategy=None):
    """Expert-parallel MoE block: the paper's decomposed all-to-all over
    the expert axis, on the dispatch and the combine.

    The process of global rank r owns experts ``[r·E/p, (r+1)·E/p)``; the
    (B, E, C, d) dispatch buffer goes out destination-major through
    ``comm.moe_route`` (the ``("moe_route", strategy)`` cells), each
    process runs the FFN of its OWN experts over every source's tokens,
    and a second ``moe_route`` brings the outputs back: two all-to-alls
    of the 1/E-expert payload instead of the whole experts' weights.  The
    slot buffer is :func:`moe_block`'s, so with ``ep_blocks=1`` the
    forward is the gathered one's (the products contract over d and f
    only).  Returns ``(out (B, T, d), aux_loss)``.

    ``experts``: a dict of expert weights (w_up, w_down[, w_gate]) whose
    leading dim is E (replicated weights, this process's block narrowed
    out) or E/p (``lane_zero3``'s never-gathered local experts).  None
    reads them from ``p``.

    ``ep_blocks > 1`` pipelines the capacity dimension: the dispatch of
    block j+1 is started (an async work handle) before block j's expert
    FFN and waited for after it, so the routing traffic runs beside the
    expert compute.  It must divide C.  The weight gradients are taken
    over the whole capacity in the last block's backward (``_EpFFN``), so
    they equal ``ep_blocks = 1``'s bit for bit.
    """
    B, T, d = x.shape
    E = cfg.num_experts
    topo = comm.topo
    n, N = topo.sizes()
    psz = max(n * N, 1)
    if E % psz:
        raise ValueError(
            f"expert-parallel requires num_experts % p == 0, got "
            f"E={E}, p={psz}")
    Eloc = E // psz
    buf, slot, keep, top_p, aux, C = _dispatch_buffer(p, x, cfg)
    if ep_blocks < 1 or C % ep_blocks:
        raise ValueError(
            f"ep_blocks={ep_blocks} must be >= 1 and divide capacity "
            f"C={C}")
    w = experts if experts is not None else p
    r = topo.global_rank()

    def loc(a):
        """This process's expert block of a whole or local weight."""
        return a if a.shape[0] == Eloc else a.narrow(0, r * Eloc, Eloc)

    w_up, w_down = loc(w["w_up"]), loc(w["w_down"])
    w_gate = loc(w["w_gate"]) if "w_gate" in w else None
    Cb = C // ep_blocks

    def dispatch(chunk):
        # (B, E, Cb, d) destination-major (each owner's experts together)
        # -> routed (p, Eloc, B, Cb, d): my experts' tokens from source s
        return _route_start(comm, chunk.transpose(0, 1).reshape(
            E * B * Cb, d), strategy)

    def combine(y):
        # y's s axis is the destination: the reverse route returns
        # (r, Eloc) = global expert r·Eloc + e
        o = _route_start(comm, y.reshape(psz * Eloc * B * Cb, d),
                         strategy)()
        return o.reshape(psz, Eloc, B, Cb, d).permute(2, 0, 1, 3, 4) \
            .reshape(B, E, Cb, d)

    cur = dispatch(buf.narrow(2, 0, Cb))
    outs, blocks = [], {"ops": {}, "k": ep_blocks}
    for j in range(ep_blocks):
        nxt = dispatch(buf.narrow(2, (j + 1) * Cb, Cb)) \
            if j + 1 < ep_blocks else None
        z = cur().reshape(psz, Eloc, B, Cb, d)
        outs.append(combine(_EpFFN.apply(z, w_up, w_gate, w_down, cfg.act,
                                         n, N, blocks, j)))
        cur = nxt
    ybuf = outs[0] if ep_blocks == 1 else torch.cat(outs, dim=2)
    return _combine(ybuf, slot, keep, top_p, x, cfg), aux
