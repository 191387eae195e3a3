"""K2 on Hopper: the CUDA SSD chunked scan and its ctypes wrapper.

Counterpart of ``repro.kernels.ssd`` (``ssd_tpu``), extended to what the
model path computes with it (``ssd_chunked``): an optional initial state,
any length T (the ragged tail is masked in the kernel) and the final
state.  The kernels are ``csrc/ssd.cu``, CUDA C++ for ``sm_90a``; its
header states what they compute, their bound on the card, their design
and where they round.  ``nvcc`` builds it at first use
(``kernels._build``).  Its one C entry point chooses by dtype: bfloat16
(every serving path) runs three kernels in order on the caller's stream
(the chunks' own states and the output on the tensor cores, the state
recurrence between them), float32 the CUDA-core kernel.  One call is one
launch of K2.

``ssd_cuda`` takes CUDA tensors only, and refuses an input that requires
grad while grad mode is on (it writes through raw pointers, so a loss
through it alone would get no gradient).  ``SSDFunction`` is K2 inside
autograd: its forward is ``ssd_cuda``, its backward ``ssd_backward``, the
autograd of the plain chunked scan recomputed in f32 (``repro`` trains
through the AD of its lax ``ssd_chunked``; it has no backward kernel).
The plain version of K2 is ``kernels.ref.ssd_chunked_ref``, and
``kernels.ops.ssd`` chooses between it and the Function by the tensors'
device.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs

from . import ref
from ._build import Library

LIBRARY = Library("ssd", {"repro_ssd_fwd": (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    ctypes.c_int)})
MAX_CHUNK = 64        # the kernels' score tile is at most 64 x 64
P_TILE = 16           # P and (bf16) S must be multiples of it
P_MAX_BF16 = 64       # widest P of the bf16 kernels (a warp's columns)
S_MAX_BF16 = 128      # widest S of the bf16 kernels (state in registers)
ALIGN = 16            # the bf16 kernels copy 16-byte chunks
_SMEM_MAX = 232448    # shared memory one block may use on sm_90
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the caller last set it to 0


def build() -> ctypes.CDLL:
    """Compile (if this source has not been built yet) and load K2."""
    return LIBRARY.load()


def _smem_bytes(dtype, P: int, S: int, Q: int) -> int:
    """Shared memory of the largest block the dtype's kernels launch."""
    if dtype == torch.float32:
        return 4 * (2 * Q * (S + 1) + P_TILE * (S + 1) + Q * P_TILE
                    + Q * (Q + 1) + 3 * Q)
    QP = -(-Q // 16) * 16           # the output kernel's tiles, padded
    return 2 * (2 * QP * (S + 8) + QP * (P + 8) + 2 * QP * (QP + 8)) \
        + 4 * 2 * MAX_CHUNK


def scratch_bytes(b: int, H: int, T: int, P: int, S: int, chunk: int) -> int:
    """Bytes of the bf16 kernels' f32 scratch: cum (b,H,T) and the chunk
    states (b, ceil(T/Q), H, P, S), Q = min(chunk, T)."""
    nc = -(-T // min(chunk, T))
    return 4 * (b * H * T + b * nc * H * P * S)


def _check(x, dt, A, B, C, init_state, chunk):
    named = [("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)]
    if init_state is not None:
        named.append(("init_state", init_state))
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise RuntimeError(
            "ssd_cuda: an input requires grad, and this raw wrapper has no "
            "backward; SSDFunction.apply (which kernels.ops.ssd calls) "
            "gives K2 its backward (ROADMAP.md, Queue 1, item 6), or call "
            "it under torch.no_grad() or torch.inference_mode()")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_cuda: {name} is on {t.device}, not a "
                             f"CUDA device")
        if t.device != x.device:
            raise ValueError("ssd_cuda: the inputs are on different devices")
        if not t.is_contiguous():
            raise ValueError(f"ssd_cuda: {name} must be contiguous "
                             f"(strides {t.stride()})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_cuda: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_cuda: B and C must have x's dtype")
    for name, t in named[1:3] + named[5:]:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_cuda: {name} must be float32, got "
                            f"{t.dtype}")
    if x.ndim != 4:
        raise ValueError(f"ssd_cuda: x must be (b, H, T, P), got shape "
                         f"{tuple(x.shape)}")
    b, H, T, P = x.shape
    if B.ndim != 3:
        raise ValueError(f"ssd_cuda: B and C must be (b, T, S) with one "
                         f"group, got shape {tuple(B.shape)}")
    S = B.shape[2]
    want = {"dt": (b, H, T), "A": (H,), "B": (b, T, S), "C": (b, T, S),
            "init_state": (b, H, P, S)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_cuda: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]} for x {tuple(x.shape)}")
    if min(b, H, T, S) < 1 or b > 65535 or H > 65535:
        raise ValueError(f"ssd_cuda: sizes out of range (b={b}, H={H}, "
                         f"T={T}, S={S})")
    if P % P_TILE:
        raise ValueError(f"ssd_cuda: head dim P={P} must be a multiple of "
                         f"{P_TILE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_cuda: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if x.dtype == torch.bfloat16:
        if S % P_TILE or P > P_MAX_BF16 or S > S_MAX_BF16:
            raise ValueError(f"ssd_cuda: the bf16 kernels take S a multiple "
                             f"of {P_TILE}, P <= {P_MAX_BF16} and S <= "
                             f"{S_MAX_BF16}, got P={P}, S={S}")
        for name, t in named[:1] + named[3:5]:
            if t.data_ptr() % ALIGN:
                raise ValueError(f"ssd_cuda: bf16 {name} must start on a "
                                 f"{ALIGN}-byte boundary")
    if _smem_bytes(x.dtype, P, S, min(chunk, T)) > _SMEM_MAX:
        raise ValueError(f"ssd_cuda: state width S={S} needs more shared "
                         f"memory than a block has")


def ssd_cuda(x, dt, A, B, C, *, chunk: int = 64, init_state=None):
    """x: (b,H,T,P) f32 or bf16; dt: (b,H,T) f32; A: (H,) f32; B, C:
    (b,T,S) in x's dtype (one group); init_state: None or (b,H,P,S) f32.
    All contiguous CUDA tensors.  Returns ``(y like x, final_state
    (b,H,P,S) f32)``.

    bfloat16 runs on the tensor-core kernels, which take 16-byte aligned
    x, B, C, P <= 64 and S <= 128 a multiple of 16, and need f32 scratch
    that this wrapper allocates: cum (b,H,T) and the chunk states (b, nc,
    H, P, S), nc = ceil(T / min(chunk, T)) (``scratch_bytes``; at
    zamba2-7b's prefill shape, H=112, P=S=64, T=792, chunk 64, the chunk
    states are 13 x 112 x 64 x 64 x 4 B = 23.9 MB).  float32 runs on the
    CUDA-core kernel, without scratch."""
    global launches
    _check(x, dt, A, B, C, init_state, chunk)
    lib = build()
    b, H, T, P = x.shape
    S = B.shape[2]
    Q = min(chunk, T)
    y = torch.empty_like(x)
    final = torch.empty((b, H, P, S), dtype=torch.float32, device=x.device)
    cum = states = None
    if x.dtype == torch.bfloat16:
        cum = torch.empty((b, H, T), dtype=torch.float32, device=x.device)
        states = torch.empty((b, -(-T // Q), H, P, S), dtype=torch.float32,
                             device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(init_state), y.data_ptr(), final.data_ptr(),
            ptr(cum), ptr(states), b, H, T, P, S, Q, _DTYPE_CODE[x.dtype],
            stream)
    LIBRARY.check(err, "ssd")
    launches += 1
    return y, final


def ssd_backward(x, dt, A, B, C, init_state, dy, dfinal, *, chunk: int,
                 needs=(True,) * 6):
    """Gradients of ``kernels.ref.ssd_chunked_ref`` at (x, dt, A, B, C,
    init_state), given the gradients ``dy`` of y and ``dfinal`` of the
    final state (either may be None: no gradient flows from it).  The
    chunked scan is recomputed in f32 under autograd, its intra-chunk decay
    masked before the exponential, so the gradient stays finite where
    ``repro``'s goes NaN (``kernels/ref.py``).  ``needs`` flags the inputs
    whose gradient is wanted; the others, and a None ``init_state``, get
    None.  Each gradient comes back in its input's dtype."""
    inputs = (x, dt, A, B, C, init_state)
    with torch.enable_grad():
        f32 = [None if t is None else t.detach().float().requires_grad_(
            bool(n)) for t, n in zip(inputs, needs)]
        y, final = ref.ssd_chunked_ref(*f32[:5], chunk=chunk,
                                       init_state=f32[5])
        outs = [(o, g.float()) for o, g in ((y, dy), (final, dfinal))
                if g is not None]
        wrt = [t for t in f32 if t is not None and t.requires_grad]
        got = torch.autograd.grad(
            [o for o, _ in outs], wrt, [g for _, g in outs],
            allow_unused=True) if outs and wrt else [None] * len(wrt)
    got, grads = iter(got), []
    for t, src in zip(f32, inputs):
        if t is None or not t.requires_grad:
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(src) if g is None else g.to(src.dtype))
    return tuple(grads)


class SSDFunction(torch.autograd.Function):
    """K2 inside autograd.  ``apply(x, dt, A, B, C, init_state, chunk)``
    with the arguments of ``ssd_cuda``: the forward launches K2 (one
    count) and returns ``(y, final_state)``, the backward is
    ``ssd_backward`` on the saved inputs.  A training step ignores the
    final state, whose gradient then arrives as None."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk):
        y, final = ssd_cuda(x, dt, A, B, C, chunk=chunk,
                            init_state=init_state)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        with obs.span("ssd_backward"):
            grads = ssd_backward(*ctx.saved_tensors, dy, dfinal,
                                 chunk=ctx.chunk,
                                 needs=ctx.needs_input_grad[:6])
        return (*grads, None)
