"""h2o-danube-3-4b — dense, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000.  SWA ⇒ sub-quadratic ⇒ long_500k runs.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10240, vocab_size=32000, sliding_window=4096,
        rope_theta=10000.0, gated_mlp=True, act="silu")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, sliding_window=16,
        dtype="float32")


register("h2o-danube-3-4b", full, smoke)
