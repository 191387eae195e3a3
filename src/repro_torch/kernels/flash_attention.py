"""K1 on Hopper: the CUDA flash-attention forward and its ctypes wrapper.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_tpu``).
The kernels are ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``; its
header states what they compute, their bound on the card, their design
and where they round.  ``nvcc`` builds it at first use (``kernels._build``)
into a shared library with a plain C interface, whose one entry point
chooses the kernel by dtype: bfloat16 (every serving path) runs on the
tensor cores, float32 on the CUDA cores.  One call is one launch.

``flash_attention_cuda`` takes CUDA tensors only, and refuses an input
that requires grad while grad mode is on: the kernel has no backward yet,
and a loss through it would get no gradient.  The plain version is
``kernels.ref.attention_ref`` and ``kernels.ops.flash_attention`` chooses
between them by the tensors' device.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import Library

LIBRARY = Library("flash_attention", {"repro_flash_attention_fwd": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)})
HEAD_DIMS = (32, 64, 112, 120, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16            # the bf16 kernel copies 16-byte chunks

launches = 0          # kernel launches since the caller last set it to 0


def build() -> ctypes.CDLL:
    """Compile (if this source has not been built yet) and load K1."""
    return LIBRARY.load()


def _check(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda: an input requires grad, and K1 has no "
            "backward yet (it comes with training, ROADMAP.md, Queue 1, "
            "item 6); call it under torch.no_grad() or "
            "torch.inference_mode()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v are on "
                             "different devices")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention_cuda: q, k, v differ in dtype")
        if t.ndim != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"contiguous (strides {t.stride()})")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not "
                        f"supported (float32, bfloat16)")
    B, H, Tq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} disagree")
    K, Tk = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention_cuda: {H} query heads are not "
                         f"a multiple of {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if min(B, H, Tq, Tk) < 1 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_cuda: sizes out of range "
                         f"(B={B}, H={H}, Tq={Tq}, Tk={Tk})")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % ALIGN:
                raise ValueError(f"flash_attention_cuda: bf16 {name} must "
                                 f"start on a {ALIGN}-byte boundary")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Tq,hd); k, v: (B,K,Tk,hd), contiguous CUDA tensors of one
    dtype, hd in ``HEAD_DIMS``.  bfloat16 (16-byte aligned) runs on the
    tensor-core kernel, float32 on the CUDA-core kernel.  Returns like
    q."""
    global launches
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib = build()
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Tq, Tk, hd, int(causal), int(window),
            _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), stream)
    LIBRARY.check(err, "flash_attention")
    launches += 1
    return out
