"""Serving steps: the ``replicated`` and ``lane_zero3`` hostings, and
serving weights from a checkpoint.

Counterpart of ``repro.serve.steps``.  Each hosting flavour is a
``("serve_step", hosting)`` registry cell, ``build_serve_step`` resolves
through the registry and ``serve_hostings`` lists the cells, as in
``repro``, which jits the entry points; here they run eagerly:

  replicated   every process holds the whole weights (the one-card
               baseline, and the only hosting of the hybrid family).
  lane_zero3   1/p weight hosting across the ranks of a topology: the
               family's ``BlockSpec`` splits the params as training does,
               each process keeps its stripes of ``shard_stack``'s f32
               masters, and every prefill and decode gathers the extras
               once and each layer one ahead (``scan_stack_cached``), so
               a group of cards serves weights none of them could hold.
               The decode slots are sharded over the global rank (each
               process owns a block of ``slots / p``), the batch-1
               prefill runs on every process from the gathered weights,
               and its fresh state goes into its slot through the
               ``kv_splice`` collective.  Each decode's logits are
               all-gathered in global-rank order (the full-lane
               ``allgather``), so every process sees
               every slot's row and the engines sample and admit in
               lockstep.  With ``model_parallel`` > 1 the topology is one
               replica of a world whose model axis is TP wide: the
               forwards run inside ``parallel_context(tp=...)``, the MLP
               as ``mlp_tp`` over the model group (``topo.model``), whose
               output equals the replicated MLP's, so the model ranks
               serve the same tokens.

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
from typing import Callable, Optional

import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.comm import CommConfig, LaneComm
from repro_torch.comm.registry import (get_impl, has_impl, register_impl,
                                       strategies_for)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lane import LaneTopology
from repro_torch.models import (ServeState, decode_step, init_cache,
                                init_model, prefill)
from repro_torch.models.blockstack import (
    RowGather, ShardedStack, block_stack_spec,
    resolve_extras_prefetch_blocks, resolve_prefetch_blocks, shard_stack,
    split_params)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.parallel import parallel_context
from repro_torch.models.transformer import check_family

__all__ = ["ServeContext", "ServeStep", "build_serve_step", "serve_hostings",
           "load_serve_params"]


@dataclasses.dataclass(frozen=True)
class ServeContext:
    """Everything a serve-step builder needs.  slots: decode batch width
    (``lane_zero3``: a multiple of the topology's p, each process owning
    a block of ``slots / p``); device: where the state lives (the params
    must be there too).  ``lane_zero3`` only: topo, the processes the
    weights and slots are sharded over (``launch.mesh.new_lane_topology``;
    ``repro`` takes a mesh); prefetch_blocks, the gather's B (0
    cost-model auto, -1 the blocking control), as ``run.fsdp_prefetch``;
    kv_strategy, the ``kv_splice`` cell (``"lane"`` or ``"native"``);
    model_parallel, the tensor-parallel degree, the size of the
    topology's model group."""
    cfg: ModelConfig
    max_seq: int
    slots: int
    device: torch.device
    topo: Optional[LaneTopology] = None
    prefetch_blocks: int = 0
    kv_strategy: str = "lane"
    model_parallel: int = 1


@dataclasses.dataclass
class ServeStep:
    """One hosting flavour's serving surface (see module docstring).
    ``collectives``: the registry cells the step resolves (empty for
    replicated); ``gathers``: the layer gathers it issued (lane_zero3),
    a callable returning the count."""
    hosting: str
    cfg: ModelConfig
    ctx: ServeContext
    prepare: Callable
    init_state: Callable
    prefill: Callable
    decode: Callable
    splice: Callable
    collectives: dict = dataclasses.field(default_factory=dict)
    gathers: Callable = lambda: 0


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


@register_impl("serve_step", "replicated", auto_ok=False)
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


@register_impl("serve_step", "lane_zero3", auto_ok=False)
def _serve_zero3(ctx: ServeContext) -> ServeStep:
    from repro_torch.launch.steps import zero3_stack_layouts
    cfg, dev, topo = ctx.cfg, ctx.device, ctx.topo
    if topo is None:
        raise ValueError("lane_zero3 serving needs a topology (slots and "
                         "weights are sharded over its processes: "
                         "launch.mesh.new_lane_topology)")
    if cfg.family == "hybrid":
        raise ValueError(
            "the hybrid family cannot serve from 1/p-sharded weights "
            "(its grouped attention cache does not fit the flat cached "
            "layer scan); use hosting='replicated'")
    tp = max(ctx.model_parallel, 1)
    if tp > 1 and (topo.model is None or topo.model.p() != tp):
        raise ValueError(
            f"model_parallel={tp} needs a model axis of that size (the "
            f"topology's model group has "
            f"{1 if topo.model is None else topo.model.p()})")
    n, N = topo.sizes()
    p = max(n * N, 1)
    if ctx.slots % p:
        raise ValueError(
            f"slots={ctx.slots} must be divisible by the chip count "
            f"p={p} (each chip owns a contiguous global-rank block)")
    lays = zero3_stack_layouts(cfg)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, ctx.prefetch_blocks)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        ctx.prefetch_blocks)
    blocking = ctx.prefetch_blocks == -1
    ccfg = CommConfig(prefetch_blocks=ctx.prefetch_blocks)
    comm = LaneComm(topo, ccfg)
    gather_b = RowGather(comm, lay_b, Bb)
    # the hosted forwards' parallel context: the TP activation collectives
    # over the model group (nothing when tp == 1)
    pkw = {} if tp == 1 else {"tp": tp,
                              "tp_comm": LaneComm(topo.model, ccfg)}
    spec = block_stack_spec(cfg)
    # slot ownership follows the global rank (lane-major, the kv_splice
    # block order); the weight stripes keep shard_stack's node-major order
    g, local = topo.global_rank(), ctx.slots // p
    idx = topo.node_rank() * N + topo.lane_rank()

    def prepare(params):
        """The replicated params -> this process's stripes of the masters
        and the family's replicated keys, on the device."""
        stack, extras, repl = split_params(spec, params)
        hosted = {k: _tree.tree_map(lambda t: t.detach().to(dev), v)
                  for k, v in repl.items()}
        for key, tree, stacked, want in (("blocks", stack, True, Bb),
                                         ("extras", extras, False, Be)):
            master, B = shard_stack(tree, n, N, ctx.prefetch_blocks,
                                    stacked=stacked)
            if B != want:
                raise RuntimeError(f"prepare resolved {key} blocks {B} but "
                                   f"the step was built for {want}")
            mine = master[:, :, idx].reshape(master.shape[0], -1).to(dev)
            del master
            hosted[key] = mine if stacked else mine[0]
        return hosted

    def _assemble(hosted):
        """The params tree the cached forwards take: the extras gathered
        once, the stack as a ShardedStack gathered layer by layer."""
        params = {k: v for k, v in hosted.items()
                  if k not in ("blocks", "extras")}
        params.update(lay_e.unflatten_row(
            comm.prefetch_allgather(hosted["extras"], num_blocks=Be)))
        params["blocks"] = ShardedStack(hosted["blocks"], gather_b,
                                        prefetch=not blocking)
        return params

    def _init():
        return _init_serve_state(cfg, local, ctx.max_seq, dev)

    @torch.no_grad()
    def _prefill(hosted, toks, true_len, extra=None):
        # batch 1 on every process from the same gathered weights; the
        # splice distributes the result to the slot's owner
        cache1 = init_cache(cfg, 1, ctx.max_seq, dtype=torch_dtype(cfg),
                            device=dev)
        toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
        if extra is not None:
            extra = torch.as_tensor(extra, dtype=torch.float32, device=dev)
        with parallel_context(**pkw):
            return prefill(_assemble(hosted), cfg, toks, cache1,
                           extra_embeds=extra, true_len=true_len)

    @torch.no_grad()
    def _decode(hosted, tok, state):
        tok = torch.as_tensor(tok, dtype=torch.long, device=dev)
        with parallel_context(**pkw):
            logits, state = decode_step(_assemble(hosted), cfg,
                                        tok[g * local:(g + 1) * local],
                                        state)
        if p == 1:
            return logits, state
        # every slot's row on every process, in global-rank order, by the
        # full-lane all-gather (AG(lane) then AG(node))
        return comm.allgather(logits.contiguous(), strategy="lane"), state

    @torch.no_grad()
    def _splice(state, st1, slot):
        sp = lambda big, small, axis=_BATCH_AXIS: comm.kv_splice(
            big, small=small, slot=int(slot), batch_axis=axis,
            strategy=ctx.kv_strategy)
        _tree.tree_map(sp, state.cache, st1.cache)
        if state.enc_kv is not None:
            _tree.tree_map(sp, state.enc_kv, st1.enc_kv)
        sp(state.length, st1.length, 0)
        return state

    return ServeStep(
        hosting="lane_zero3", cfg=cfg, ctx=ctx, prepare=prepare,
        init_state=_init, prefill=_prefill, decode=_decode, splice=_splice,
        collectives={"weights": ("prefetch_allgather", "blocking"
                                 if blocking else "lane_pipelined"),
                     "kv": ("kv_splice", ctx.kv_strategy)},
        gathers=lambda: gather_b.gathers)


def serve_hostings() -> tuple:
    """Registered serve_step hostings, in registration order (the derived
    table benches/tests enumerate)."""
    return strategies_for("serve_step")


def build_serve_step(cfg: ModelConfig, *, max_seq: int, slots: int,
                     hosting: str = "replicated", device="cuda",
                     topo: Optional[LaneTopology] = None,
                     prefetch_blocks: int = 0, kv_strategy: str = "lane",
                     model_parallel: int = 1) -> ServeStep:
    """Build ``hosting`` for ``cfg`` on ``device`` (``lane_zero3``: over
    ``topo``; see ``ServeContext``)."""
    if not has_impl("serve_step", hosting):
        raise ValueError(
            f"unknown serving hosting {hosting!r}; registered: "
            f"{serve_hostings()}")
    if model_parallel > 1 and hosting != "lane_zero3":
        raise ValueError(
            f"model_parallel > 1 needs hosting='lane_zero3' (got "
            f"{hosting!r}); replicated hosting has no mesh to carry the "
            f"'model' axis")
    check_family(cfg)
    ctx = ServeContext(cfg=cfg, max_seq=int(max_seq), slots=int(slots),
                       device=resolve_device(device), topo=topo,
                       prefetch_blocks=int(prefetch_blocks),
                       kv_strategy=kv_strategy,
                       model_parallel=int(model_parallel))
    return get_impl("serve_step", hosting).fn(ctx)


# ---------------------------------------------------------------------------
# checkpoint -> serving weights
# ---------------------------------------------------------------------------

def load_serve_params(ckpt_dir: str, cfg: ModelConfig, step=None, *,
                      device="cuda"):
    """Replicated serving weights from a training checkpoint of any
    layout (``repro``'s or the port's), on ``device``: the canonical
    leaves read once (crc-verified, by the manifest's dtypes) and lifted
    to the replicated form by ``launch.steps.load_canonical_params``
    (``state_to_replicated``, the path a training restart takes), the
    optimizer state dropped, each
    parameter cast to the model's dtype.  A ``lane_zero3`` step re-shards
    them in ``prepare``, so a checkpoint written at p processes serves
    at any p'.  Returns ``(params, step)``."""
    from repro_torch.launch.steps import load_canonical_params
    dev = resolve_device(device)
    params, got = load_canonical_params(ckpt_dir, cfg, step)
    params_t = init_model(cfg, device="meta")
    params = _tree.tree_map(lambda v, t: v.to(device=dev, dtype=t.dtype),
                            params, params_t)
    return params, got
