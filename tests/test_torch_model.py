"""The port's dense model against ``repro``'s, at smoke size.

llama3.2-3b in f32 and bf16; the other dense configs in f32, which take
the remaining dense code paths: layernorm + plain GELU MLP (granite-34b),
QKV bias (qwen1.5-110b) and a sliding window (h2o-danube-3-4b).

Both packages start from the same numbers: ``repro.models.init_model``'s
tree goes through ``repro_torch.bridge``, and inputs are numpy draws.
Tolerances, relative to the largest magnitude of the reference:
  * f32: 1e-5 — the two frameworks order their f32 reductions
    differently, nothing more (logits reach ~64, so ~6e-4 absolute);
  * bf16: 2e-2 — bf16 rounds at different points in the two packages
    (JAX's blocked attention scales q in bf16 and rounds p per block;
    the plain attention here does both in f32), a few bf16 ulps.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.models import attention as jA
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit
from repro.models import layers as jL
from repro.models import model_forward as jforward
from repro.models import prefill as jprefill
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.models import (decode_step, init_cache, init_model,
                                model_forward, prefill)
from repro_torch.models import attention as A
from repro_torch.models import layers as L

ARCH = "llama3.2-3b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(ARCH, "float32"), (ARCH, "bfloat16"), ("granite-34b", "float32"),
         ("qwen1.5-110b", "float32"), ("h2o-danube-3-4b", "float32")]


def _cfgs(dtype="float32", arch=ARCH):
    jc = dataclasses.replace(jresolve(arch, smoke=True), dtype=dtype)
    tc = dataclasses.replace(resolve(arch, smoke=True), dtype=dtype)
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _weights(dtype="float32", arch=ARCH):
    jc, tc = _cfgs(dtype, arch)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, params_from_repro(tree, tc, device="cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm():
    x, s, b = _rand((2, 5, 64), 0), _rand((64,), 1), _rand((64,), 2)
    _close(L.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x), 1e-5),
           jL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5),
           TOL["float32"])
    _close(L.layernorm({"scale": torch.tensor(s), "bias": torch.tensor(b)},
                       torch.tensor(x), 1e-5),
           jL.layernorm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                        jnp.asarray(x), 1e-5), TOL["float32"])


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_at_offset_positions(theta):
    x = _rand((2, 6, 4, 16), 3)
    pos = np.array([[5, 6, 7, 8, 9, 10], [40, 41, 42, 43, 44, 45]])
    _close(L.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           TOL["float32"])


def test_mlp():
    jc, tc, jp, tp = _weights()
    x = _rand((2, 7, tc.d_model), 4)
    _close(L.mlp(tp["blocks"][1]["mlp"], torch.tensor(x), tc),
           jL.mlp(jax.tree.map(lambda a: a[1], jp["blocks"])["mlp"],
                  jnp.asarray(x), jc), TOL["float32"])


def test_qkv():
    jc, tc, jp, tp = _weights()
    x = _rand((2, 7, tc.d_model), 5)
    pos = np.arange(7)[None] + np.array([[0], [9]])
    got = A.qkv(tp["blocks"][0]["attn"], torch.tensor(x), tc,
                positions=torch.tensor(pos))
    want = jA.qkv(jax.tree.map(lambda a: a[0], jp["blocks"])["attn"],
                  jnp.asarray(x), jc, positions=jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(window):
    """The port's decode window keeps window + 1 keys, as repro's prefill
    and no-cache forward do; repro's decode_attention keeps window, so it
    is compared at window + 1 (a departure of the port, ROADMAP.md,
    Queue 3)."""
    B, S, H, K, hd = 3, 24, 4, 2, 16
    q, kc, vc = _rand((B, 1, H, hd), 6), _rand((B, S, K, hd), 7), \
        _rand((B, S, K, hd), 8)
    lens = np.array([1, 13, 24], np.int32)
    _close(A.decode_attention(torch.tensor(q), torch.tensor(kc),
                              torch.tensor(vc), torch.tensor(lens),
                              window=window),
           jA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens),
                               window=window + 1 if window else 0),
           TOL["float32"])


# ---------------------------------------------------------------------------
# whole model: no-cache forward, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", CASES)
def test_model_forward(arch, dtype):
    jc, tc, jp, tp = _weights(dtype, arch)
    toks = np.random.default_rng(9).integers(1, tc.vocab_size, (2, 24))
    got, _ = model_forward(tp, tc, torch.tensor(toks))
    want, _ = jforward(jp, jc, jnp.asarray(toks, jnp.int32))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_decode(arch, dtype):
    """A 21-token prompt padded to a 32 bucket (``true_len`` < bucket),
    then four decode steps: logits, cache and lengths against repro
    (whose decode keeps one key fewer of a sliding window than its
    prefill, so its decode runs at window + 1: see test_decode_attention)."""
    jc, tc, jp, tp = _weights(dtype, arch)
    jdc = dataclasses.replace(jc, sliding_window=jc.sliding_window + 1) \
        if jc.sliding_window else jc
    S, T, true_len = 48, 32, 21
    rng = np.random.default_rng(10)
    toks = np.zeros((1, T), np.int64)
    toks[0, :true_len] = rng.integers(1, tc.vocab_size, true_len)
    cache = init_cache(tc, 1, S, dtype=L.torch_dtype(tc), device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, true_len=true_len)
    jcache = jinit_cache(jc, 1, S, dtype=jnp.dtype(dtype))
    want, jst = jprefill(jp, jc, jnp.asarray(toks, jnp.int32), jcache,
                         true_len=true_len)
    _close(got, want, TOL[dtype])
    assert st.length.tolist() == np.asarray(jst.length).tolist()
    for name in ("k", "v"):
        _close(st.cache[name], jst.cache[name], TOL[dtype])
    for _ in range(4):
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
        want, jst = jdecode(jp, jdc, jnp.asarray(tok, jnp.int32), jst)
        _close(got, want, TOL[dtype])
        assert st.length.tolist() == np.asarray(jst.length).tolist()
    for name in ("k", "v"):
        _close(st.cache[name], jst.cache[name], TOL[dtype])


@pytest.mark.parametrize("L", [10, 16, 17, 40])
def test_sliding_window_decode_equals_no_cache_forward(L):
    """h2o-danube-3-4b (window 16 at smoke size) in f32: a prompt shorter
    than, at and past the window, then three decode steps; each step's
    logits equal repro's no-cache forward over the prompt and the tokens
    so far (K1's window: positions >= qpos - window), as the prefill's
    do."""
    jc, tc, jp, tp = _weights("float32", "h2o-danube-3-4b")
    toks = np.random.default_rng(L).integers(1, tc.vocab_size, (1, L))
    cache = init_cache(tc, 1, 64, dtype=torch.float32, device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, true_len=L)
    for _ in range(3):
        want, _ = jforward(jp, jc, jnp.asarray(toks, jnp.int32))
        _close(got[:, -1], want[:, -1], TOL["float32"])
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        toks = np.concatenate([toks, tok], 1)
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
    want, _ = jforward(jp, jc, jnp.asarray(toks, jnp.int32))
    _close(got[:, -1], want[:, -1], TOL["float32"])


def test_decode_past_capacity_leaves_cache():
    """A row whose length reached S is not written (repro's one-hot
    write matches no position there) and the step still runs."""
    _, tc, _, tp = _weights()
    cache = init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
    cache["k"].normal_(generator=torch.Generator().manual_seed(0))
    before = cache["k"].clone()
    from repro_torch.models import ServeState
    st = ServeState(cache=cache, length=torch.tensor([3, 8], dtype=torch.int32))
    _, st = decode_step(tp, tc, torch.tensor([[5], [6]]), st)
    assert torch.equal(st.cache["k"][:, 1], before[:, 1])
    assert not torch.equal(st.cache["k"][:, 0, 3], before[:, 0, 3])
    assert st.length.tolist() == [4, 9]


# ---------------------------------------------------------------------------
# bridge and init
# ---------------------------------------------------------------------------

def test_bridge_consumes_every_leaf():
    jc, tc = _cfgs()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
    params = params_from_repro(tree, tc, device="cpu")
    n_port = sum(t.numel() for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n_port == sum(a.size for a in jax.tree.leaves(tree))
    extra = {**tree, "stray": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        params_from_repro(extra, tc, device="cpu")
    missing = {**tree, "final_norm": {}}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_repro(missing, tc, device="cpu")


def test_init_model_is_seeded_and_follows_repro_distribution():
    _, tc = _cfgs()
    a = init_model(tc, seed=3, device="cpu")
    b = init_model(tc, seed=3, device="cpu")
    c = init_model(tc, seed=4, device="cpu")
    wq = a["blocks"][0]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"][0]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"][0]["attn"]["wq"])
    assert float(wq.abs().max()) <= 0.04 + 1e-7        # [-2, 2] x 0.02
    tok = a["embed"]["tok"]
    assert float(tok.abs().max()) <= 2.0 and float(tok.std()) > 0.5
    assert torch.equal(a["final_norm"]["scale"], torch.ones(tc.d_model))


@pytest.mark.parametrize("arch", ["dbrx-132b", "granite-moe-3b-a800m",
                                  "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_other_families_name_their_slice(arch):
    """The moe, vlm and audio families (ported in their own slice of
    ROADMAP.md's Queue 1, item 4) build, from a seed, the tree of leaves,
    shapes and dtypes that the bridge makes of repro's init; an unknown
    family raises."""
    jc, tc = jresolve(arch, smoke=True), resolve(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
    want = params_from_repro(tree, tc, device="cpu")
    a, b = (init_model(tc, seed=3, device="cpu") for _ in range(2))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))[0])
    fa, fb, fw = flat(a), flat(b), flat(want)
    assert set(fa) == set(fw)
    for path, leaf in fw.items():
        assert fa[path].shape == leaf.shape and fa[path].dtype == \
            leaf.dtype, path
        assert torch.equal(fa[path], fb[path]), path
    with pytest.raises(ValueError, match="unknown family"):
        init_model(dataclasses.replace(tc, family="video"), device="cpu")
