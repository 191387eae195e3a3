"""mamba2-780m — pure SSM (attention-free), SSD dual form.

[arXiv:2405.21060; unverified]  48L d_model=1536 (attn-free) d_ff=0
vocab=50280, ssm_state=128.  d_inner = 2·d = 3072, head_dim 64 ⇒ 48 heads.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
        tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
        tie_embeddings=True, dtype="float32")


register("mamba2-780m", full, smoke)
