"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres patch prefix.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The vision tower is a STUB per spec:
input_specs() supplies precomputed patch embeddings (576 tokens, one
24×24 CLIP grid) which pass through a learned projector; seq_len counts
the full backbone sequence (vision prefix + text).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, vision_tokens=576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, vision_tokens=8, dtype="float32")


register("llava-next-mistral-7b", full, smoke)
