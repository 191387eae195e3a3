"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  32L d_model=1536 24H
(GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.  40 experts do not divide
the 16-way model axis — the TP-expert layout (d_ff column-sharded) handles
this with no padding experts (DESIGN.md §4).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        num_experts=40, experts_per_token=8)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=32, vocab_size=256,
        num_experts=10, experts_per_token=3, dtype="float32")


register("granite-moe-3b-a800m", full, smoke)
