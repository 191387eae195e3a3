"""granite-34b — dense code model, GPT-BigCode-style MQA (kv=1).

[arXiv:2405.04324; hf]  88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152.  LayerNorm + plain-GELU MLP; rotary used in place of the
original learned absolute positions (simplification noted in DESIGN.md).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        norm="layernorm", gated_mlp=False, act="gelu")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=256, vocab_size=256,
        norm="layernorm", gated_mlp=False, act="gelu", dtype="float32")


register("granite-34b", full, smoke)
