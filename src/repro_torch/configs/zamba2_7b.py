"""zamba2-7b — hybrid: Mamba2 backbone + one weight-SHARED attention block.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32, i.e. full MHA
in the shared block) d_ff=14336 vocab=32000, ssm_state=64.  The shared
attention+MLP block is applied every 6 Mamba2 layers (13 applications,
3 trailing Mamba2 layers) — weight sharing as published; the concatenated
residual-input trick of the original is simplified to standard residual
insertion (DESIGN.md §4).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
        hybrid_attn_every=6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
        hybrid_attn_every=3, dtype="float32")


register("zamba2-7b", full, smoke)
