"""llama3.2-3b — small llama3 dense GQA with tied embeddings.

[hf:meta-llama/Llama-3.2-1B; unverified]  28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
        tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, tie_embeddings=True, dtype="float32")


register("llama3.2-3b", full, smoke)
