"""K2 on Hopper: the CUDA SSD chunked scan and its ctypes wrapper.

Counterpart of ``repro.kernels.ssd`` (``ssd_tpu``), extended to what the
model path computes with it (``ssd_chunked``): an optional initial state,
any length T (the ragged tail is masked in the kernel) and the final
state.  The kernel is ``csrc/ssd.cu``, CUDA C++ for ``sm_90a``; its
header states what it computes, its bound on the card and its design.
``nvcc`` builds it at first use (``kernels._build``).

``ssd_cuda`` takes CUDA tensors only; the plain version is
``kernels.ref.ssd_chunked_ref`` and ``kernels.ops.ssd`` chooses between
them by the tensors' device.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Library

LIBRARY = Library("ssd")
MAX_CHUNK = 64        # the kernel's score tile is at most 64 x 64
P_TILE = 16           # state rows per thread block; P must divide by it
_SMEM_MAX = 232448    # shared memory one block may use on sm_90
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the caller last set it to 0


def build() -> ctypes.CDLL:
    """Compile (if this source has not been built yet) and load K2."""
    lib = LIBRARY.load()
    lib.repro_ssd_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p])
    lib.repro_ssd_fwd.restype = ctypes.c_int
    return lib


def _smem_bytes(Q: int, S: int) -> int:
    return 4 * (2 * Q * (S + 1) + P_TILE * (S + 1) + Q * P_TILE
                + Q * (Q + 1) + 3 * Q)


def _check(x, dt, A, B, C, init_state, chunk):
    named = [("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)]
    if init_state is not None:
        named.append(("init_state", init_state))
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
    if _smem_bytes(min(chunk, T), S) > _SMEM_MAX:
        raise ValueError(f"ssd_cuda: state width S={S} needs more shared "
                         f"memory than a block has")


def ssd_cuda(x, dt, A, B, C, *, chunk: int = 64, init_state=None):
    """x: (b,H,T,P) f32 or bf16; dt: (b,H,T) f32; A: (H,) f32; B, C:
    (b,T,S) in x's dtype (one group); init_state: None or (b,H,P,S) f32.
    All contiguous CUDA tensors.  Returns ``(y like x, final_state
    (b,H,P,S) f32)``."""
    global launches
    _check(x, dt, A, B, C, init_state, chunk)
    lib = build()
    b, H, T, P = x.shape
    S = B.shape[2]
    y = torch.empty_like(x)
    final = torch.empty((b, H, P, S), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init_state is None else
            init_state.data_ptr(), y.data_ptr(), final.data_ptr(),
            b, H, T, P, S, min(chunk, T), _DTYPE_CODE[x.dtype], stream)
    LIBRARY.check(err, "ssd")
    launches += 1
    return y, final
