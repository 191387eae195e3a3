"""whisper-large-v3 — encoder-decoder audio backbone, conv frontend STUB.

[arXiv:2212.04356; unverified]  Decoder 32L d_model=1280 20H (kv=20, MHA)
d_ff=5120 vocab=51866; encoder 32L over 1500 stub frame embeddings
(the conv1d+log-mel frontend is stubbed per spec — input_specs() provides
precomputed frame embeddings).  LayerNorm + GELU, QKV bias, cross-attn in
every decoder layer.  Decode shapes lower the DECODER serve_step.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866, qkv_bias=True,
        norm="layernorm", gated_mlp=False, act="gelu",
        encoder_layers=32, encoder_seq=1500, cross_attention=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, qkv_bias=True,
        norm="layernorm", gated_mlp=False, act="gelu",
        encoder_layers=2, encoder_seq=16, cross_attention=True,
        dtype="float32")


register("whisper-large-v3", full, smoke)
