"""K1's plain version (the CPU path of the port's ``flash_attention``)
against ``repro``'s Pallas kernel run in interpret mode.

The CUDA kernel itself cannot run here (no card, no nvcc); ``chip_smoke.py``
holds it against this same plain version on the H100.  Tolerances are
``repro``'s own kernel-test tolerances: 2e-5 for f32 (reduction order
only) and 2e-2 for bf16 (the Pallas kernel rounds p to bf16 before PV,
the plain version does not).
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

ATT_SHAPES = [
    # B, H, K, Tq, Tk, hd, bq, bk  (as in tests/test_kernels.py)
    (1, 2, 2, 128, 128, 64, 64, 64),
    (2, 4, 2, 256, 256, 64, 128, 128),
    (1, 8, 2, 256, 512, 32, 128, 128),    # GQA G=4, cross lengths
    (1, 2, 1, 512, 512, 128, 256, 128),   # MQA
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (None, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, H, K, Tq, Tk, hd, dtype, seed=0):
    """numpy draws rounded to ``dtype`` once, handed to both packages."""
    _, jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s) for s in
            ((B, H, Tq, hd), (B, K, Tk, hd), (B, K, Tk, hd))]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (np.asarray(j.astype(jnp.float32)) for j in jx)]
    return jx, tx


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("mode", ["causal", "full", "window"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ATT_SHAPES)
def test_flash_attention_matches_repro(shape, dtype, mode):
    B, H, K, Tq, Tk, hd, bq, bk = shape
    causal = mode == "causal"
    window = 96 if mode == "window" else 0
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, Tq, Tk, hd, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    if causal and Tq != Tk:
        # repro's kernel test covers causal only on square shapes; the
        # top-left-aligned mask for Tq != Tk is held to repro's oracle
        want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    else:
        want = flash_attention_tpu(jq, jk, jv, causal=causal,
                                   window=window, block_q=bq, block_k=bk,
                                   interpret=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_padding_kblocks():
    """Tk not a multiple of the block: trailing keys masked, as in repro."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 128, 96, 32, "f32")
    got = ops.flash_attention(q, k, v, causal=False)
    want = flash_attention_tpu(jq, jk, jv, causal=False, block_q=64,
                               block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_cpu_path_launches_no_kernel():
    before = fa.launches
    _, (q, k, v) = _inputs(1, 4, 2, 64, 64, 32, "f32")
    ops.flash_attention(q, k, v, causal=True)
    assert fa.launches == before == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: a CPU tensor is an error."""
    _, (q, k, v) = _inputs(1, 2, 2, 16, 16, 32, "f32")
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(q, k, v)
    assert fa.launches == 0


@pytest.mark.parametrize("which", [0, 1, 2])
def test_cuda_wrapper_refuses_grad(which):
    """The raw wrapper has no backward: under grad mode an input that
    requires grad raises (before any device test, so it is pinned here
    without a card), naming the autograd Function that carries K1's
    backward; under no_grad or inference_mode the same call reaches the
    device test."""
    _, qkv = _inputs(1, 2, 2, 16, 16, 32, "f32")
    qkv[which].requires_grad_(True)
    with pytest.raises(RuntimeError,
                       match="no backward.*FlashAttentionFunction.*item 6"):
        fa.flash_attention_cuda(*qkv)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), pytest.raises(ValueError, match="not a CUDA device"):
            fa.flash_attention_cuda(*qkv)
    assert fa.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (1, 4, 2, 256, 256, True, 96),       # window masking keys, GQA
    (1, 2, 1, 192, 192, True, 0),        # MQA, causal
    (2, 2, 2, 128, 128, False, 40),      # window without causality
], ids=["window96", "mqa_causal", "window40_full"])
def test_flash_attention_hd120_matches_repro(shape, dtype):
    """Head dim 120 (h2o-danube-3-4b: 3840 / 32), which K1's tensor-core
    design pads to 128 columns in shared memory: the plain version against
    repro's Pallas kernel in interpret mode, with a window that really
    masks keys."""
    B, H, K, Tq, Tk, causal, window = shape
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, Tq, Tk, 120, dtype, seed=120)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert 120 in fa.HEAD_DIMS


def test_k1_signature_is_set_at_load():
    """K1's C entry point's ctypes signature, set once when the library
    loads (not on every call): four pointers, nine ints (dtype among
    them: the entry point chooses the kernel by it), the scale, the
    stream."""
    import ctypes
    argtypes, restype = fa.LIBRARY.signatures["repro_flash_attention_fwd"]
    assert argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    assert restype is ctypes.c_int
    assert fa._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1}


def test_ops_refuses_other_devices():
    q = torch.empty((1, 2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)


def test_each_kernel_builds_its_own_hashed_library():
    """K1 and K2 share one nvcc build (``kernels._build``): each source
    goes to ``build/kernels/lib<name>-<hash>.so``, hashed over the source
    and the headers the sources share (``csrc/*.cuh``)."""
    import hashlib
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as k2
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["tensor_core.cuh"]
    paths = {}
    for mod, name in ((fa, "flash_attention"), (k2, "ssd")):
        lib = mod.LIBRARY
        h = hashlib.sha256(lib.source.read_bytes())
        for header in headers:
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        assert lib.source == _build.CSRC / f"{name}.cu"
        assert lib.path() == _build.BUILD_DIR / f"lib{name}-{digest}.so"
        paths[name] = lib.path()
    assert paths["flash_attention"] != paths["ssd"]
    assert 112 in fa.HEAD_DIMS


# ---------------------------------------------------------------------------
# where K1's bf16 tensor-core kernel rounds (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _k1_bf16_model(q, k, v, *, causal, window):
    """K1's bf16 kernel in plain f32 PyTorch, rounding where it rounds.

    Per 64-row q tile, over the in-band 64-key tiles the kernel walks:
    S = q . k^T of the bf16 inputs summed in f32, the scale 1/sqrt(hd)
    (times log2 e) applied after the product, masked scores -1e30; each
    half of a key tile (32 keys) keeps its own online softmax (m, l and
    the accumulator in f32, p rounded to bf16 for P . V and kept f32 in
    l); the two halves merge at the end; out = acc / max(l, 1e-30),
    rounded once to bf16."""
    BQ = BK = 64
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    nk = -(-Tk // BK)
    pad = lambda t: torch.nn.functional.pad(
        t.repeat_interleave(G, 1).float(), (0, 0, 0, nk * BK - Tk))
    kf, vf = pad(k), pad(v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        * (math.log2(math.e) / math.sqrt(hd))
    qpos = torch.arange(Tq)[:, None]
    kpos = torch.arange(nk * BK)[None, :]
    keep = kpos < Tk
    if causal:
        keep = keep & (qpos >= kpos)
    if window:
        keep = keep & (kpos >= qpos - window)
    s = torch.where(keep, s, torch.tensor(-1e30))
    out = torch.empty(B, H, Tq, hd)
    for q0 in range(0, Tq, BQ):
        rows = slice(q0, min(q0 + BQ, Tq))
        k_lo = max(q0 - window, 0) if window else 0
        k_hi = min(min(q0 + BQ, Tq), Tk) if causal else Tk
        halves = []
        for half in (0, 1):
            n = rows.stop - rows.start
            m = torch.full((B, H, n), -1e30)
            l = torch.zeros(B, H, n)
            acc = torch.zeros(B, H, n, hd)
            for kt in range(k_lo // BK, -(-k_hi // BK)):
                keys = slice(kt * BK + 32 * half, kt * BK + 32 * half + 32)
                st = s[:, :, rows, keys]
                m_new = torch.maximum(m, st.max(-1).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(st - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + _bf16(p) @ vf[:, :, keys]
                m = m_new
            halves.append((m, l, acc))
        (m0, l0, a0), (m1, l1, a1) = halves
        mm = torch.maximum(m0, m1)
        f0, f1 = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
        den = torch.clamp(l0 * f0 + l1 * f1, min=1e-30)
        out[:, :, rows] = (a0 * f0[..., None] + a1 * f1[..., None]) \
            / den[..., None]
    return out.to(q.dtype)


K1_MODEL_SHAPES = [
    # B, H, K, Tq, Tk, hd
    (1, 2, 2, 128, 128, 64),
    (1, 8, 2, 256, 512, 32),      # GQA, Tq != Tk
    (1, 2, 2, 387, 387, 112),     # ragged, zamba2-7b's head dim
    (1, 2, 1, 3, 3, 128),         # shorter than one tile
    (1, 4, 2, 200, 200, 120),     # h2o-danube-3-4b's head dim
]


@pytest.mark.parametrize("mode", ["causal", "full", "window"])
@pytest.mark.parametrize("shape", K1_MODEL_SHAPES,
                         ids=[f"Tq{s[3]}_Tk{s[4]}_hd{s[5]}"
                              for s in K1_MODEL_SHAPES])
def test_k1_bf16_rounding_design_matches_repro(shape, mode):
    """The bf16 design (bf16 operands, f32 sums, the scale after q . k^T,
    p in bf16, two key halves merged) is within K1's bf16 tolerance of
    repro's Pallas kernel in interpret mode (of repro's oracle where its
    kernel test has no such case: causal with Tq != Tk)."""
    B, H, K, Tq, Tk, hd = shape
    causal = mode == "causal"
    window = 96 if mode == "window" else 0
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, Tq, Tk, hd, "bf16", seed=Tq)
    got = _k1_bf16_model(q, k, v, causal=causal, window=window)
    if causal and Tq != Tk:
        want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    else:
        want = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                                   block_q=128, block_k=128, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)
