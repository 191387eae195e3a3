"""Model configs, input-shape presets and the arch registry.

The port's own copy of ``repro.configs.base`` (``ModelConfig``,
``ShapeConfig``, ``SHAPES`` and ``register``/``resolve``/``all_archs``),
kept field for field so both packages resolve the same numbers.  Every
arch module registers a ``ModelConfig`` with the published numbers plus a
reduced ``smoke()`` variant of the same family.  ``RunConfig`` holds only
the training knobs the port honours so far (``repro``'s has also the ZeRO
and parallelism knobs, ROADMAP.md Queue 1 items 9-10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads
    # attention
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention; >0 = SWA width
    rope_theta: float = 10000.0
    # mlp
    gated_mlp: bool = True         # SwiGLU vs plain GELU MLP
    act: str = "silu"
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # ssm (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    # hybrid (Zamba2): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 0
    # encoder-decoder (Whisper): frontend stubbed to frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False
    # vlm: stub patch-embedding prefix of this many tokens
    vision_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def ssm_heads(self) -> int:
        return self.d_inner() // self.ssm_head_dim

    # -- parameter count (analytic, for roofline MODEL_FLOPS) -------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd, H, K = self.hd(), self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # lm head
        per_attn = d * H * hd + 2 * d * K * hd + H * hd * d
        if self.qkv_bias:
            per_attn += (H + 2 * K) * hd
        per_mlp = (3 if self.gated_mlp else 2) * d * f
        if self.family == "moe":
            E = self.experts_per_token if active_only else self.num_experts
            per_mlp = (3 if self.gated_mlp else 2) * d * f * E + d * self.num_experts
        per_norms = 2 * d
        if self.family == "ssm":
            di, S, Hs = self.d_inner(), self.ssm_state, self.ssm_heads()
            G = self.ssm_groups
            per_layer = (d * (2 * di + 2 * G * S + Hs)    # in_proj
                         + self.ssm_conv_width * (di + 2 * G * S)
                         + 3 * Hs + di                    # A, D, dt_bias, norm
                         + di * d + d)                    # out_proj + ln
            total += L * per_layer
        elif self.family == "hybrid":
            di, S, Hs = self.d_inner(), self.ssm_state, self.ssm_heads()
            G = self.ssm_groups
            per_m = (d * (2 * di + 2 * G * S + Hs)
                     + self.ssm_conv_width * (di + 2 * G * S)
                     + 3 * Hs + di + di * d + d)
            total += L * per_m
            total += per_attn + per_mlp + per_norms       # one shared block
        else:
            total += L * (per_attn + per_mlp + per_norms)
            if self.encoder_layers:
                total += self.encoder_layers * (per_attn + per_mlp + per_norms)
                if self.cross_attention:                  # decoder cross-attn
                    total += L * (per_attn + d)
        total += d                                        # final norm
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One training run: the fields of ``repro``'s ``RunConfig`` that the
    port honours, validated at construction as ``repro`` validates them.

    ``remat``: ``"none"`` | ``"full"`` | ``"dots"`` (save the products
    with no batch dimensions, recompute the rest).  ``gradsync``: the
    gradient sync and parameter layout, ``"native"``, ``"lane"``,
    ``"lane_pipelined"`` or ``"lane_int8"`` (the replicated step),
    ``"lane_quorum"`` (the replicated step with a quorum mask),
    ``"lane_zero1"`` or ``"lane_zero3"`` (the ZeRO steps), or ``"auto"``
    (the replicated step, each sync dispatched by measured-then-modelled
    cost, ``comm.LaneComm.select``).  ``gradsync_buckets``: the
    bucket count K of the lane strategies (0 = cost-model auto).
    ``fsdp_prefetch``: ``lane_zero3``'s per-layer gather blocks B (0 =
    cost-model auto, > 0 that many, -1 = the blocking gather, no
    prefetch); ``fsdp_regather``: gather each layer again in the
    backward (the step builder refuses it together with -1, as
    ``repro``'s does).  ``microbatch``: gradient-accumulation
    microbatches per step (0 = off).  ``accum_dtype``: their
    accumulator, ``"float32"`` or ``"bfloat16"``."""
    model: ModelConfig
    remat: str = "none"
    gradsync: str = "native"
    gradsync_buckets: int = 0
    fsdp_prefetch: int = 0
    fsdp_regather: bool = False
    microbatch: int = 0
    accum_dtype: str = "float32"

    def __post_init__(self):
        if self.accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"accum_dtype must be 'float32' or 'bfloat16', got "
                f"{self.accum_dtype!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat policy {self.remat!r}; have "
                             f"'none', 'full', 'dots'")
        if self.microbatch < 0:
            raise ValueError(f"microbatch must be >= 0, got "
                             f"{self.microbatch}")
        # which strategies are ported is the registry's to say
        from repro_torch.comm.registry import (has_impl, strategies_for,
                                               unported_item)
        # "auto" is meta: per-call dispatch, tuned
        if self.gradsync != "auto" \
                and not has_impl("grad_sync", self.gradsync):
            item = unported_item("grad_sync", self.gradsync)
            if item is not None:
                raise NotImplementedError(
                    f"gradsync={self.gradsync!r} is not ported yet "
                    f"({item})")
            raise ValueError(f"unknown gradsync {self.gradsync!r}; have "
                             f"{strategies_for('grad_sync')}")
        if self.gradsync_buckets < 0:
            raise ValueError(f"gradsync_buckets must be >= 0, got "
                             f"{self.gradsync_buckets}")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def resolve(arch_id: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs as _  # ensure arch modules imported  # noqa: F401
    table = _SMOKE if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(table)}")
    return table[arch_id]()


def all_archs() -> list[str]:
    import repro_torch.configs as _  # noqa: F401
    return sorted(_REGISTRY)
