"""K1's plain version (the CPU path of the port's ``flash_attention``)
against ``repro``'s Pallas kernel run in interpret mode.

The CUDA kernel itself cannot run here (no card, no nvcc); ``chip_smoke.py``
holds it against this same plain version on the H100.  Tolerances are
``repro``'s own kernel-test tolerances: 2e-5 for f32 (reduction order
only) and 2e-2 for bf16 (the Pallas kernel rounds p to bf16 before PV,
the plain version does not).
"""
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


def test_ops_refuses_other_devices():
    q = torch.empty((1, 2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)


def test_each_kernel_builds_its_own_hashed_library():
    """K1 and K2 share one nvcc build (``kernels._build``): each source
    goes to ``build/kernels/lib<name>-<hash of the source>.so``."""
    import hashlib
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as k2
    paths = {}
    for mod, name in ((fa, "flash_attention"), (k2, "ssd")):
        lib = mod.LIBRARY
        digest = hashlib.sha256(lib.source.read_bytes()).hexdigest()[:16]
        assert lib.source == _build.CSRC / f"{name}.cu"
        assert lib.path() == _build.BUILD_DIR / f"lib{name}-{digest}.so"
        paths[name] = lib.path()
    assert paths["flash_attention"] != paths["ssd"]
    assert 112 in fa.HEAD_DIMS
