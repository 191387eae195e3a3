"""K1 on Hopper: the CUDA flash-attention forward and its ctypes wrapper.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_tpu``).
The kernels are ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``; its
header states what they compute, their bound on the card, their design
and where they round.  ``nvcc`` builds it at first use (``kernels._build``)
into a shared library with a plain C interface, whose one entry point
chooses the kernel by dtype: bfloat16 (every serving path) runs on the
tensor cores, float32 on the CUDA cores.  One call is one launch.

``flash_attention_cuda`` takes CUDA tensors only, and refuses an input
that requires grad while grad mode is on: it writes through raw pointers,
so a loss through it alone would get no gradient.
``FlashAttentionFunction`` is K1 inside autograd: its forward is
``flash_attention_cuda`` and its backward ``attention_backward``, plain
PyTorch in f32, the counterpart of what ``repro`` trains through (the AD
of its lax attention; ``repro`` has no backward kernel).  The plain
version of K1 is ``kernels.ref.attention_ref``, and
``kernels.ops.flash_attention`` chooses between it and the Function by the
tensors' device.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import obs

from . import ref
from ._build import Library

LIBRARY = Library("flash_attention", {"repro_flash_attention_fwd": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)})
HEAD_DIMS = (16, 32, 64, 112, 120, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16            # the bf16 kernel copies 16-byte chunks

launches = 0          # kernel launches since the caller last set it to 0


def build() -> ctypes.CDLL:
    """Compile (if this source has not been built yet) and load K1."""
    return LIBRARY.load()


def _check(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda: an input requires grad, and this raw "
            "wrapper has no backward; FlashAttentionFunction.apply (which "
            "kernels.ops.flash_attention calls) gives K1 its backward "
            "(ROADMAP.md, Queue 1, item 6), or call it under "
            "torch.no_grad() or torch.inference_mode()")
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


def attention_backward(q, k, v, out, dout, *, causal: bool = True,
                       window: int = 0):
    """Gradients of ``kernels.ref.attention_ref`` at (q, k, v): ``(dq, dk,
    dv)``, each in its input's dtype, given the forward's output ``out``
    and its gradient ``dout`` (B,H,Tq,hd).  In f32: the masked
    probabilities P are recomputed, then ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P o (dP - rowsum(dO o O))``, ``dQ = scale dS K`` and ``dK =
    scale dS^T Q``, with the G query heads of each K/V head summed into
    its dK and dV.  It holds B·H·Tq·Tk f32 scores a few times over
    (llama3.2-3b at B=4, T=1024: 0.4 GB each), one layer at a time."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, K, G, Tq, hd)        # head h = K/V head h // G
    kf, vf = k.float(), v.float()
    mask = ref.attention_mask(Tq, Tk, causal=causal, window=window,
                              device=q.device)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf / math.sqrt(hd), kf)
    p = torch.softmax(s.masked_fill(~mask, ref.NEG_INF), dim=-1)
    del s
    do = dout.float().reshape(B, K, G, Tq, hd)
    delta = (do * out.float().reshape(B, K, G, Tq, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", do, vf) - delta)
    del p
    ds = ds.masked_fill(~mask, 0.0)     # a row with no key: no gradient
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(B, H, Tq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """K1 inside autograd.  ``apply(q, k, v, causal, window)`` with the
    arguments of ``flash_attention_cuda``: the forward launches K1 (one
    count), the backward is ``attention_backward`` on the saved q, k, v
    and output.  Under ``torch.utils.checkpoint`` the forward runs again
    in the backward, and launches K1 again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        with obs.span("attention_backward"):
            dq, dk, dv = attention_backward(q, k, v, out, dout,
                                            causal=ctx.causal,
                                            window=ctx.window)
        return dq, dk, dv, None, None
