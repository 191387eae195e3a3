"""Model zoo of the port: every family of ``repro`` (see ROADMAP.md)."""
from .transformer import (ServeState, decode_step, init_cache, init_model,
                          loss_fn, make_train_step, model_forward, prefill)

__all__ = ["ServeState", "decode_step", "init_cache", "init_model",
           "loss_fn", "make_train_step", "model_forward", "prefill"]
