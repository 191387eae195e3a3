"""Dispatch by device: the kernel for CUDA tensors, the plain version on CPU.

Counterpart of ``repro.kernels.ops``.  There is no switch: a CPU tensor
goes to the plain PyTorch version (``kernels.ref``), whose autograd the
CPU tests train through; a CUDA tensor goes to the hand-written kernel
inside its ``torch.autograd.Function`` (the kernel forward, a plain f32
backward), with grad on or off, and the kernel's wrapper raises if it
cannot run.  Any other device raises.  On the card each kernel's C entry point
chooses by dtype: bfloat16, the serving paths' dtype, runs on the tensor
cores, float32 on the CUDA cores; neither falls back on the other.
"""
from __future__ import annotations

from . import ref
from .flash_attention import FlashAttentionFunction
from .ssd import SSDFunction


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Tq,hd); k,v: (B,K,Tk,hd) — head-major convention."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def ssd(x, dt, A, B, C, *, chunk: int, init_state=None):
    """x: (b,H,T,P); dt: (b,H,T); A: (H,); B,C: (b,T,S); init_state: None
    or (b,H,P,S) f32.  Returns ``(y (b,H,T,P), final_state (b,H,P,S))``."""
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                                   init_state=init_state)
    if x.device.type == "cuda":
        return SSDFunction.apply(x, dt, A, B, C, init_state, chunk)
    raise ValueError(f"ssd: no kernel for device {x.device}")
