"""The dry-run planner: every (arch x shape x mesh) cell planned, not
compiled.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for the TPU mesh and reads the compiler's memory and cost analyses
and the collectives out of the optimized HLO.  The port has no compiler
to ask: it plans.  For each cell it makes ``repro``'s decisions
(:func:`plan`: FSDP above 10e9 parameters or under the ``tp0`` plan,
remat ``"full"`` for training, the microbatch from the token budget) and
maps them onto the port's own layouts:

  * ``fsdp`` -> ``--gradsync lane_zero3`` (the 1/p f32 master stripes of
    ``launch.steps``), else ``auto`` (the replicated step, each gradient
    sync ranked by the cost model); a serving cell hosts its weights the
    same way (``serve_step`` ``lane_zero3``, else ``replicated``);
  * the model axis -> ``--model-parallel`` (the MLP's column-parallel
    ``mlp_tp``), 1 under ``tp0``, where the model axis joins the batch;
  * the world -> the topology ``launch.mesh.make_lane_topology`` builds
    on it (``launch.mesh.lane_sizes``).

Each mapping that departs from ``repro``'s is written into the cell's
``departures``.  From the plan it computes, per rank (:func:`run_cell`):

  * ``state_bytes``: params, f32 masters, AdamW moments, experts, cache
    and inputs, from meta-device trees and the port's own layouts
    (``zero3_stack_layouts`` / ``zero3_checkpoint_layout``,
    ``zero1_opt_init``'s padding, ``init_cache``); ``fits`` holds them
    against the card's 80 GB, activations not planned.  The port's TP
    replicates the weights (every model rank computes with its column
    block of the whole matrix), so the model axis divides no state;
  * ``flops``: :func:`train_flops` (a train cell) or the forward's
    closed form (a serving cell);
  * ``collectives``: the calls one step issues, per kind ``{count,
    bytes, wire_bytes}`` in ``analysis.footprint``'s wire units, and the
    wire per level.  The level sums come from ``comm.costs.
    lowered_wire_volumes`` for each registry cell the step calls (under
    ``auto`` the strategy ``LaneComm.select`` picks from the cost model
    alone), and are held against the per-call decomposition; the scalar
    side channels (the loss mean, the global norm: one element each) are
    left out.

Which levels cross a host.  The world rank is ``(pod·d + data)·m +
model``, and an H100 host holds 8 consecutive ranks
(``launch.cluster.GPUS_PER_HOST``).  Under ``repro``'s production mesh the
16-wide model axis spans two hosts, so every level crosses a host: the
model group (16 ranks, 2 hosts), the node level (the data ranks of one
pod, 16 apart) and the lane level (the pods, 256 apart).  Under ``tp0``
the node level (the whole data axis of a pod) spans its pod's 32 hosts
and the lane level crosses pods.  The paper's layout, the node level
inside a host, would need a model axis of at most 8 with the data axis
outside it; each cell's ``crosses_host`` says which of its levels cross
one.

``repro``'s compile, ``memory_analysis``, ``cost_analysis``, the HLO text
(and its ``hlo_stats``) and the f32-mirror bytes of XLA:CPU have no
counterpart here, and ``--accum-bf16`` none either: nothing is lowered.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi] [--plan tp0] [--microbatch M]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Results land in ``runs/dryrun_torch/{single,multi}/<arch>__<shape>.json``.
``--all`` runs in one process: no device count needs locking.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.comm.costs import lowered_wire_volumes
from repro_torch.configs import (SHAPES, ModelConfig, RunConfig, ShapeConfig,
                                 all_archs, resolve)
from repro_torch.launch.cluster import GPUS_PER_HOST
from repro_torch.launch.mesh import (MeshSpec, batch_axes,
                                     make_production_mesh, lane_sizes,
                                     mesh_sizes)

__all__ = ["Plan", "plan", "input_shapes", "train_flops", "forward_flops",
           "attention_pairs", "train_state_bytes", "serve_state_bytes",
           "step_collectives", "run_cell", "list_cells", "main",
           "CARD_BYTES"]

RUNS = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"

#: the H100's memory, against which ``fits`` holds the planned state
CARD_BYTES = 80e9

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int32": 4, "int64": 8}
_TOKEN_BYTES = 8      # the port's token ids are torch.long


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One cell's decisions: ``repro``'s (``fsdp``, ``run.remat``,
    ``run.microbatch``, ``plan``) and the port's layouts they map onto
    (``run.gradsync``, ``run.model_parallel``, ``hosting``, the
    topology's ``n``, ``N`` and ``tp``)."""
    run: RunConfig
    shape: ShapeConfig
    mesh: MeshSpec
    fsdp: bool
    plan: str
    n: int
    N: int
    tp: int
    hosting: "str | None"
    departures: tuple

    @property
    def p(self) -> int:
        return self.n * self.N

    @property
    def single(self) -> bool:
        return self.n == 1


def _batch_axes_for(mesh: MeshSpec, plan_name: str) -> tuple:
    ba = batch_axes(mesh)
    return (*ba, "model") if plan_name == "tp0" else ba


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, *,
         micro_override: int = 0, plan_name: str = "default") -> Plan:
    """``repro``'s decisions for one cell, on the port's layouts."""
    sizes = mesh_sizes(mesh)
    nb = math.prod(sizes[a] for a in _batch_axes_for(mesh, plan_name))
    fsdp = cfg.param_count() > 10e9 or plan_name == "tp0"
    micro = 0
    if shape.kind == "train":
        b_loc = max(shape.global_batch // nb, 1)
        # the per-microstep token budget: wide models halve it
        tok_budget = 8192 if cfg.d_model <= 4096 else 4096
        rows = max(1, tok_budget // shape.seq_len)
        micro = max(1, b_loc // rows)
    if micro_override:
        micro = micro_override
    tp = 1 if plan_name == "tp0" else sizes.get("model", 1)
    dep = ["fsdp (GSPMD parameter and optimizer sharding over the batch "
           "axes) maps to the lane_zero3 layout's 1/p f32 master stripes"
           if fsdp else
           "the replicated layout with every gradient sync ranked by the "
           "cost model (gradsync auto)"]
    if tp > 1:
        dep.append(f"the model axis maps to --model-parallel {tp}: mlp_tp "
                   f"splits the MLP's products, not its weights, so the "
                   f"model axis divides no state (repro shards heads, "
                   f"d_ff, vocab and experts over it)")
    gradsync = "lane_zero3" if fsdp else "auto"
    hosting = None
    if shape.kind != "train":
        hosting = "lane_zero3" if fsdp else "replicated"
        if hosting == "lane_zero3" and cfg.family == "hybrid":
            hosting = "replicated"
            dep.append("the hybrid family cannot serve from 1/p stripes "
                       "(serve_step lane_zero3 refuses it): replicated "
                       "hosting")
    n, N, m = lane_sizes(mesh, gradsync=gradsync, tp=tp)
    if "pod" not in sizes and n > 1:
        dep.append(f"the pod-less data axis splits into {N} lanes of {n} "
                   f"(resolve_pods for lane_zero3, as launch.train with "
                   f"--pods 0)")
    if shape.global_batch % (n * N):
        dep.append(f"the global batch of {shape.global_batch} does not "
                   f"split over {n * N} batch ranks: every rank takes all "
                   f"of it, as repro's tiny-batch cells (launch.train "
                   f"refuses such a batch)")
    run = RunConfig(model=cfg, remat="full" if shape.kind == "train"
                    else "none", gradsync=gradsync, microbatch=micro,
                    model_parallel=tp)
    return Plan(run, shape, mesh, fsdp, plan_name, n, N, m, hosting,
                tuple(dep))


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``{name: (global shape, dtype name) or None}``: ``repro``'s
    ``input_specs`` without the shardings (the port's token ids are
    int64 on the card; the shapes are these)."""
    B, T = shape.global_batch, shape.seq_len
    extra = None
    t_text = T
    if cfg.family == "vlm":
        t_text = T - cfg.vision_tokens
        extra = ((B, cfg.vision_tokens, cfg.d_model), cfg.dtype)
    elif cfg.family == "audio":
        extra = ((B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    tok = lambda n, t: ((n, t), "int32")
    if shape.kind == "train":
        return {"tokens": tok(B, t_text), "labels": tok(B, t_text),
                "extra": extra}
    if shape.kind == "prefill":
        return {"tokens": tok(B, t_text), "extra": extra}
    return {"token": tok(B, 1), "extra": extra}


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def attention_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the masks keep: the work an attention of this shape
    needs."""
    qpos = np.arange(Tq)
    hi = np.minimum(qpos + 1, Tk) if causal else np.full(Tq, Tk)
    lo = np.maximum(qpos - window, 0) if window else np.zeros(Tq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def _attention_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers
    return 0


def train_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N per token (N the parameters a
    token uses, the experts it is routed to for a MoE; the tied
    unembedding's product included) plus 3x the causal attention's
    forward (QK^T and PV over the pairs the mask keeps); the SSD scan's
    own operations, the hybrid's shared attention and whisper's encoder
    attention are left out, and the encoder's parameters are charged per
    decoder token."""
    flops = 6 * cfg.param_count(active_only=True) * batch * seq
    flops += 3 * 4 * cfg.hd() * cfg.num_heads * _attention_layers(cfg) \
        * batch * attention_pairs(seq, seq, True, cfg.sliding_window)
    return float(flops)


def forward_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """One serving step's model FLOPs: a prefill of the whole batch, or
    one decode token per row against a context of ``seq_len``."""
    B, T = shape.global_batch, shape.seq_len
    w = cfg.sliding_window
    if shape.kind == "prefill":
        pairs, tokens = attention_pairs(T, T, True, w), T
    else:
        pairs, tokens = min(T, w + 1) if w else T, 1
    return float(2 * cfg.param_count(active_only=True) * B * tokens
                 + 4 * cfg.hd() * cfg.num_heads * _attention_layers(cfg)
                 * B * pairs)


# ---------------------------------------------------------------------------
# state bytes per rank
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


def _meta_params(cfg: ModelConfig):
    from repro_torch.models import init_model
    return init_model(cfg, device="meta")


def train_state_bytes(run: RunConfig, n: int, N: int, *,
                      single: bool = False) -> dict:
    """What ``init_lane_train_state`` keeps on each rank of an n x N
    topology for ``run`` (the init tree dropped): ``params`` in the
    model's dtype, f32 ``masters`` (zero3's stripes), AdamW ``moments``
    (m and v), and ``experts`` (expert-parallel zero3's f32 E/p block
    and its moments)."""
    from repro_torch.launch.steps import (layout_kind, split_expert_stack,
                                          zero3_stack_layouts, _stripe_len)
    from repro_torch.models.blockstack import (
        block_stack_spec, resolve_extras_prefetch_blocks,
        resolve_prefetch_blocks, split_params)
    from repro_torch.optim.gradsync import resolve_num_buckets
    cfg = run.model
    params = _meta_params(cfg)
    kind = layout_kind(run, single)
    out = dict(params=0, masters=0, moments=0, experts=0)
    if kind == "replicated":
        out["params"] = _nbytes(params)
        out["moments"] = 2 * 4 * sum(t.numel()
                                     for t in _tree.leaves(params))
        return out
    if kind == "zero1":
        total = sum(t.numel() for t in _tree.leaves(params))
        K = resolve_num_buckets(total, n, run.gradsync_buckets)
        out["params"] = _nbytes(params)
        out["moments"] = 2 * 4 * (-(-total // (K * n)) * K)
        return out
    p = n * N
    lays = zero3_stack_layouts(cfg, ep=run.expert_parallel)
    lay_b, lay_e = lays["blocks"], lays["extras"]
    Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N, run.fsdp_prefetch)
    Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                        run.fsdp_prefetch)
    stripes = lay_b.length * _stripe_len(lay_b, n, N, Bb) \
        + _stripe_len(lay_e, n, N, Be)
    stack, _, repl = split_params(block_stack_spec(cfg), params)
    out["params"] = _nbytes(repl)
    out["masters"] = 4 * stripes
    out["moments"] = 2 * 4 * (stripes + sum(t.numel()
                                            for t in _tree.leaves(repl)))
    if run.expert_parallel:
        _, experts = split_expert_stack(stack)
        mine = sum(t.numel() for lp in experts for t in lp.values()) // p
        out["experts"] = 3 * 4 * mine        # f32 weights, m and v
    return out


def serve_state_bytes(cfg: ModelConfig, hosting: str, n: int, N: int,
                      rows: int, max_seq: int) -> dict:
    """A serving rank's weights (``params`` replicated, or zero3's f32
    ``masters``, as ``serve_step``'s ``prepare`` keeps them) and its
    ``rows`` slots of cache at ``max_seq`` (whisper's ``enc_kv`` too)."""
    from repro_torch.launch.steps import zero3_stack_layouts, _stripe_len
    from repro_torch.models import init_cache
    from repro_torch.models.blockstack import (
        block_stack_spec, resolve_extras_prefetch_blocks,
        resolve_prefetch_blocks, split_params)
    params = _meta_params(cfg)
    out = dict(params=0, masters=0, moments=0, experts=0)
    if hosting == "replicated":
        out["params"] = _nbytes(params)
    else:
        lays = zero3_stack_layouts(cfg)
        lay_b, lay_e = lays["blocks"], lays["extras"]
        Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N)
        Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N)
        out["masters"] = 4 * (lay_b.length * _stripe_len(lay_b, n, N, Bb)
                              + _stripe_len(lay_e, n, N, Be))
        _, _, repl = split_params(block_stack_spec(cfg), params)
        out["params"] = _nbytes(repl)
    dt = getattr(torch, cfg.dtype)
    cache = _nbytes(init_cache(cfg, rows, max_seq, dtype=dt, device="meta"))
    if cfg.family == "audio":
        cache += 2 * cfg.num_layers * rows * cfg.encoder_seq \
            * cfg.num_kv_heads * cfg.hd() * _DTYPE_BYTES[cfg.dtype]
    out["cache"] = cache
    return out


def _rows(B: int, p: int) -> int:
    """A rank's rows of a global batch: its share, or all of them when the
    batch does not split (``repro``'s tiny-batch cells)."""
    return B // p if B % p == 0 else B


def _input_bytes(cfg: ModelConfig, shape: ShapeConfig, p: int) -> int:
    total = 0
    for name, spec in input_shapes(cfg, shape).items():
        if spec is None:
            continue
        dims, dtype = spec
        per = math.prod(dims[1:]) * _rows(dims[0], p)
        total += per * (_TOKEN_BYTES if dtype == "int32"
                        else _DTYPE_BYTES[dtype])
    return total


def state_bytes(pl: Plan) -> dict:
    cfg, shape = pl.run.model, pl.shape
    if shape.kind == "train":
        out = train_state_bytes(pl.run, pl.n, pl.N, single=pl.single)
        out["cache"] = 0
    else:
        out = serve_state_bytes(cfg, pl.hosting, pl.n, pl.N,
                                _rows(shape.global_batch, pl.p),
                                shape.seq_len)
    out["inputs"] = _input_bytes(cfg, shape, pl.p)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# collectives: the calls one step issues
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Op:
    """``count`` issues of one ``torch.distributed`` call: its footprint
    kind, its group (``"node"``, ``"lane"``, ``"global"``, ``"model"`` or
    ``"self"``, a group of this rank alone) and the result bytes the wire
    convention is written against."""
    kind: str
    group: str
    result: float
    count: int


class _Calls:
    """The ops of one step and the registry cells that issued them."""

    def __init__(self, n: int, N: int, tp: int):
        self.n, self.N, self.tp = n, N, tp
        self.ops: list = []
        self.cells: list = []        # (collective, strategy, group, c, count)

    def size(self, group: str) -> int:
        return {"node": self.n, "lane": self.N, "global": self.n * self.N,
                "model": self.tp, "self": 1}[group]

    def op(self, kind, group, result, count=1):
        if count and result:
            self.ops.append(_Op(kind, group, float(result), int(count)))

    def cell(self, collective, strategy, group, payload, count=1):
        if count and payload:
            self.cells.append((collective, strategy, group, float(payload),
                               int(count)))


def _grad_sync(calls: _Calls, strategy: str, leaves: list, K_override=0):
    """One ``comm.grad_sync`` of gradient leaves ``[(numel, bytes per
    element)]`` under ``strategy`` (``auto``: the cost model's pick)."""
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.launch.steps import _local_topology
    from repro_torch.optim.gradsync import resolve_num_buckets
    n, N = calls.n, calls.N
    total = sum(e for e, _ in leaves)
    if strategy == "auto":
        comm = LaneComm(_local_topology(), CommConfig())
        strategy, _ = comm.select("grad_sync", total * 4, n=n, N=N)
    if strategy == "native":          # one all-reduce a leaf
        sizes = [e * b for e, b in leaves]
        for c in sizes:
            calls.op("all-reduce", "global", c)
        calls.cell("grad_sync", "native", "global", sum(sizes))
        return strategy
    K = resolve_num_buckets(total, n, K_override)
    flat = -(-total // (K * n)) * K * n * 4
    blk = flat / K
    if strategy == "lane":
        calls.op("reduce-scatter", "node", blk / n, K)
        calls.op("all-reduce", "lane", blk / n, K)
        calls.op("all-gather", "node", blk, K)
    elif strategy == "lane_pipelined":
        calls.op("reduce-scatter", "node", blk / n, K)
        calls.op("send", "lane", blk / n, K * (N - 1))
        calls.op("recv", "lane", blk / n, K * (N - 1))
        calls.op("all-gather", "node", blk, K)
    else:
        raise ValueError(f"no planned collectives for grad_sync "
                         f"{strategy!r}")
    calls.cell("grad_sync", strategy, None, flat)
    return strategy


def _row_gather(calls: _Calls, stripe: int, B: int, count: int,
                transpose: bool = False):
    """``count`` pipelined gathers (or their transposes) of one row whose
    stripe is ``stripe`` f32 elements a rank, in ``B`` blocks."""
    n, N = calls.n, calls.N
    s = stripe // B * 4
    if transpose:
        calls.op("reduce-scatter", "node", N * s, B * count)
        calls.op("reduce-scatter", "lane", s, B * count)
        calls.cell("grad_sync", "lane_zero3", None, n * N * s * B, count)
    else:
        calls.op("all-gather", "lane", N * s, B * count)
        calls.op("all-gather", "node", n * N * s, B * count)
        calls.cell("prefetch_allgather", "lane_pipelined", None,
                   s * B, count)


def _mlp_calls(cfg: ModelConfig, seq: int, *, encoder: bool) -> list:
    """``[(MLP runs, tokens a row)]`` of one forward over ``seq`` tokens
    (``_ffn``'s dense path); ``encoder``: whisper's encoder runs too."""
    if cfg.family in ("moe", "ssm"):
        return []
    if cfg.family == "hybrid":
        return [(cfg.num_layers // cfg.hybrid_attn_every, seq)]
    if cfg.family == "audio" and encoder:
        return [(cfg.num_layers, seq), (cfg.encoder_layers, cfg.encoder_seq)]
    return [(cfg.num_layers, seq)]


def _tp_allgather(calls: _Calls, payload: float, count: int,
                  gradsync: str):
    """``count`` model-group all-gathers of ``payload`` bytes a rank
    (``_allgather_last`` on the n = 1, N = tp model topology, whose
    communicator takes the run's ``gradsync`` where ``allgather`` has
    that strategy, else the cost model's pick)."""
    from repro_torch.comm import CommConfig, LaneComm, has_impl
    from repro_torch.launch.steps import _local_topology
    tp = calls.tp
    strategy = gradsync
    if not has_impl("allgather", strategy):
        comm = LaneComm(_local_topology(), CommConfig())
        strategy, _ = comm.select("allgather", int(payload), n=1, N=tp)
    calls.op("all-gather", "model", tp * payload, count)
    if strategy != "native":          # then AG over a node of one rank
        calls.op("all-gather", "self", tp * payload, count)
    calls.cell("allgather", strategy, "model", payload, count)


def _tp_calls(calls: _Calls, run: RunConfig, rows: int, seq: int,
              count: int, *, encoder: bool, backward: bool):
    """The MLP's gathers over ``count`` forwards (or backwards) of
    ``rows`` rows: forward the f/tp activation and the d/tp output,
    backward the whole f-cotangent(s), then dx."""
    cfg = run.model
    b = _DTYPE_BYTES[cfg.dtype]
    f_gathers = (2 if cfg.gated_mlp else 1) if backward else 1
    for k, t in _mlp_calls(cfg, seq, encoder=encoder):
        tok = rows * t
        _tp_allgather(calls, tok * cfg.d_ff // calls.tp * b,
                      k * count * f_gathers, run.gradsync)
        _tp_allgather(calls, tok * cfg.d_model // calls.tp * b, k * count,
                      run.gradsync)


def _tp_leaves(params) -> list:
    from repro_torch.launch.steps import _is_tp_leaf
    return [t for path, t in _tree.flatten(params) if _is_tp_leaf(path)]


def _tp_stripe_elems(lay, n: int, N: int, B: int, rank_idx: int) -> int:
    """TP-weight elements in stripe ``rank_idx`` of a row (the masked
    all-reduce of the zero3 TP assembly): the row's TP intervals
    against the stripe's B pieces."""
    from repro_torch.launch.steps import _is_tp_leaf, _stripe_len
    p = n * N
    s = _stripe_len(lay, n, N, B) // B
    spans, ofs = [], 0
    for path, (shape, _) in zip(lay.paths, lay.metas):
        sz = math.prod(shape)
        if _is_tp_leaf(path):
            spans.append((ofs, ofs + sz))
        ofs += sz
    total = 0
    for b in range(B):
        lo = (b * p + rank_idx) * s
        hi = lo + s
        total += sum(max(0, min(hi, e) - max(lo, a)) for a, e in spans)
    return total


def step_collectives(pl: Plan, *, rank_idx: int = 0) -> dict:
    """The collectives one step of ``pl`` issues on a rank (stripe index
    ``rank_idx`` where the zero3 TP assembly's bytes depend on it)."""
    from repro_torch.launch.steps import (layout_kind, zero3_stack_layouts,
                                          _stripe_len)
    from repro_torch.models.blockstack import (
        block_stack_spec, resolve_extras_prefetch_blocks,
        resolve_prefetch_blocks, split_params)
    run, cfg, shape = pl.run, pl.run.model, pl.shape
    n, N, tp = pl.n, pl.N, pl.tp
    calls = _Calls(n, N, tp)
    train = shape.kind == "train"
    rows = _rows(shape.global_batch, pl.p)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    mb = max(run.microbatch, 1) if train else 1
    mrows = rows // mb
    encoder = shape.kind != "decode"        # whisper's encoder runs too
    tp_on = tp > 1 and bool(_mlp_calls(cfg, seq, encoder=encoder))
    kind = layout_kind(run, pl.single) if train else (
        "zero3" if pl.hosting == "lane_zero3" else "replicated")
    remat = run.remat in ("full", "dots")
    params = _meta_params(cfg)
    grad_b = 4 if train and run.microbatch > 1 else \
        _DTYPE_BYTES[cfg.dtype]
    sync = None
    if kind == "zero3":
        lays = zero3_stack_layouts(cfg, ep=run.expert_parallel)
        lay_b, lay_e = lays["blocks"], lays["extras"]
        Bb = resolve_prefetch_blocks(lay_b.row_elems, n, N,
                                     run.fsdp_prefetch)
        Be = resolve_extras_prefetch_blocks(lay_e.row_elems, n, N,
                                            run.fsdp_prefetch)
        sb, se = _stripe_len(lay_b, n, N, Bb), _stripe_len(lay_e, n, N, Be)
        L = lay_b.length
        _row_gather(calls, se, Be, 1)
        gathers = L * mb * (2 if train and run.fsdp_regather else 1)
        _row_gather(calls, sb, Bb, gathers)
        if train:
            _row_gather(calls, sb, Bb, L * mb, transpose=True)
            _row_gather(calls, se, Be, 1, transpose=True)
    if tp_on:
        _tp_calls(calls, run, mrows, seq, mb * (2 if train and remat
                                               else 1),
                  encoder=encoder, backward=False)
        if train:
            _tp_calls(calls, run, mrows, seq, mb, encoder=encoder,
                      backward=True)
    if train and kind == "zero3":
        if tp_on:
            k = _tp_stripe_elems(lay_b, n, N, Bb, rank_idx)
            calls.op("all-reduce", "model", 4 * k, L)
        _, _, repl = split_params(block_stack_spec(cfg), params)
        leaves = [(t.numel(), grad_b) for t in _tree.leaves(repl)]
        if leaves:
            if tp_on:
                for t in _tp_leaves(repl):
                    calls.op("all-reduce", "model", t.numel() * grad_b)
            _grad_sync(calls, "lane", leaves, run.gradsync_buckets)
        sync = "lane_zero3"
    elif train:
        if tp_on:
            for t in _tp_leaves(params):
                calls.op("all-reduce", "model", t.numel() * grad_b)
        eff = "native" if pl.single else run.gradsync
        leaves = [(t.numel(), grad_b) for t in _tree.leaves(params)]
        sync = _grad_sync(calls, eff, leaves, run.gradsync_buckets)
    return _summary(calls, sync)


def _wire(kind: str, g: int, result: float) -> float:
    from repro_torch.analysis.footprint import _footprint_wire
    return _footprint_wire(kind, g, result)


def _summary(calls: _Calls, sync) -> dict:
    per_kind: dict = {}
    level = collections.Counter()
    for o in calls.ops:
        w = _wire(o.kind, calls.size(o.group), o.result) * o.count
        rec = per_kind.setdefault(o.kind, {"count": 0, "bytes": 0.0,
                                           "wire_bytes": 0.0})
        rec["count"] += o.count
        rec["bytes"] += o.result * o.count
        rec["wire_bytes"] += w
        level[o.group] += w
    # the level sums from the registry cells' closed forms
    closed = collections.Counter()
    for coll, strategy, group, c, count in calls.cells:
        if group == "model":
            vol = lowered_wire_volumes(coll, strategy, n=1, N=calls.tp,
                                       payload_bytes=c)
            vol = {"model": sum(vol.values())}
        else:
            vol = lowered_wire_volumes(coll, strategy, n=calls.n,
                                       N=calls.N, payload_bytes=c)
        for lv, b in vol.items():
            closed[lv] += b * count
    for o in calls.ops:
        if o.kind == "all-reduce" and o.group == "model":
            g = calls.tp
            closed["model"] += _wire(o.kind, g, o.result) * o.count
    level["model"] += level.pop("self", 0.0)
    for lv in ("node", "lane", "global", "model"):
        if not math.isclose(closed[lv], level[lv], rel_tol=1e-9,
                            abs_tol=1.0):
            raise AssertionError(
                f"planned {lv} wire {level[lv]} != the closed forms' "
                f"{closed[lv]}")
    return {"per_kind": per_kind,
            "node_wire_bytes": closed["node"],
            "lane_wire_bytes": closed["lane"],
            "global_wire_bytes": closed["global"],
            "model_wire_bytes": closed["model"],
            "grad_sync": sync}


def crosses_host(n: int, N: int, tp: int) -> dict:
    """Whether rank 0's node, lane and model groups span more than one
    8-GPU host (world rank ``(j·n + i)·tp + k``)."""
    host = lambda ranks: len({r // GPUS_PER_HOST for r in ranks}) > 1
    w = lambda j, i, k: (j * n + i) * tp + k
    return {"node": host([w(0, i, 0) for i in range(n)]),
            "lane": host([w(j, 0, 0) for j in range(N)]),
            "model": host([w(0, 0, k) for k in range(tp)])}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: "pathlib.Path | None" = None, *,
             micro_override: int = 0, plan_name: str = "default",
             tag: str = "") -> dict:
    cfg = resolve(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    pl = plan(cfg, shape, mesh, micro_override=micro_override,
              plan_name=plan_name)
    state = state_bytes(pl)
    flops = train_flops(cfg, shape.global_batch, shape.seq_len) \
        if shape.kind == "train" else forward_flops(cfg, shape)
    colls = step_collectives(pl)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "chips": mesh.size, "hosts": mesh.size // GPUS_PER_HOST,
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "fsdp": pl.fsdp, "microbatch": pl.run.microbatch,
        "remat": pl.run.remat, "plan": pl.plan,
        "gradsync": pl.run.gradsync, "grad_sync": colls.pop("grad_sync"),
        "hosting": pl.hosting, "model_parallel": pl.tp,
        "topology": {"n": pl.n, "N": pl.N, "tp": pl.tp},
        "crosses_host": crosses_host(pl.n, pl.N, pl.tp),
        "inputs": {k: None if v is None else
                   {"shape": list(v[0]), "dtype": v[1]}
                   for k, v in input_shapes(cfg, shape).items()},
        "state_bytes": state,
        "fits": {"ok": state["total"] <= CARD_BYTES,
                 "card_bytes": CARD_BYTES,
                 "note": "state only; activations not planned"},
        "flops": flops,
        "collectives": colls,
        "departures": list(pl.departures),
        "plan_s": time.perf_counter() - t0,
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "")
        path = out_dir / f"{stem}.json"
        path.write_text(json.dumps(result, indent=1))
        result["json"] = str(path)
    return result


def list_cells():
    rows = []
    for a in all_archs():
        cfg = resolve(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if s == "long_500k" and not cfg.subquadratic:
                rows.append((a, s, "SKIP (full attention; DESIGN.md §4)"))
            else:
                rows.append((a, s, "run"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--plan", default="default", choices=["default", "tp0"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RUNS),
                    help="results directory (default runs/dryrun_torch)")
    args = ap.parse_args(argv)
    runs = pathlib.Path(args.out)

    if args.list:
        for a, s, st in list_cells():
            print(f"{a:28s} {s:12s} {st}")
        return 0

    if args.all:
        fails = []
        meshes = [False, True] if args.both_meshes else [args.multi]
        for multi in meshes:
            sub = runs / ("multi" if multi else "single")
            for a, s, st in list_cells():
                if st != "run":
                    continue
                if args.skip_existing and (sub / f"{a}__{s}.json").exists():
                    print(f"skip existing {a} {s}")
                    continue
                try:
                    r = run_cell(a, s, multi, sub,
                                 micro_override=args.microbatch,
                                 plan_name=args.plan, tag=args.tag)
                except Exception as e:  # noqa: BLE001 - one cell's failure
                    fails.append((a, s, multi))
                    print(f"FAIL {a} {s} {'multi' if multi else 'single'}: "
                          f"{e!r}", flush=True)
                    continue
                print(f"{a:28s} {s:12s} {'multi' if multi else 'single':6s}"
                      f" {r['gradsync']:10s} state "
                      f"{r['state_bytes']['total'] / 1e9:8.2f} GB "
                      f"fits={r['fits']['ok']!s:5s} flops "
                      f"{r['flops']:.3e} wire node "
                      f"{r['collectives']['node_wire_bytes'] / 1e9:.3f} "
                      f"lane {r['collectives']['lane_wire_bytes'] / 1e9:.3f}"
                      f" GB", flush=True)
        print(f"\nFAILED CELLS: {fails if fails else 'none'}")
        return len(fails)

    out = runs / ("multi" if args.multi else "single")
    res = run_cell(args.arch, args.shape, args.multi, out,
                   micro_override=args.microbatch, plan_name=args.plan,
                   tag=args.tag)
    print(json.dumps(res, indent=1))
    print("DRYRUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
