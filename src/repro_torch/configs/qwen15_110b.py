"""qwen1.5-110b — dense GQA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=49152, vocab_size=152064, qkv_bias=True,
        rope_theta=1_000_000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=256, qkv_bias=True, dtype="float32")


register("qwen1.5-110b", full, smoke)
