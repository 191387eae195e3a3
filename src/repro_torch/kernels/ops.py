"""Dispatch by device: the kernel for CUDA tensors, the plain version on CPU.

Counterpart of ``repro.kernels.ops``.  There is no switch: a CPU tensor
goes to the plain PyTorch version (``kernels.ref``), a CUDA tensor goes
to the hand-written kernel, and the kernel's wrapper raises if it cannot
run.  Any other device raises.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_cuda


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Tq,hd); k,v: (B,K,Tk,hd) — head-major convention."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
