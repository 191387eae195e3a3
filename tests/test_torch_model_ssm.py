"""The port's ssm and hybrid models and their serving against ``repro``'s.

mamba2-780m (ssm) and zamba2-7b (hybrid: a Mamba2 backbone with one
shared attention block) at smoke size in f32.  Both packages start from
``repro.models.init_model``'s weights through ``repro_torch.bridge``, and
inputs are numpy draws.  Tolerance 1e-5 of the reference's largest
magnitude (at least 1): only the frameworks' f32 reduction order differs.
Greedy tokens are held identical: at that agreement the two best logits
of these random-weight models are far apart compared with the error.
In bf16 (``test_bf16_matches_repro``) the tolerance is 2e-2, as for
llama3.2-3b in tests/test_torch_model.py: the two packages round bf16 at
different points (the scan's operands, the conv, the norms), a few bf16
ulps of the logits; measured, 4.0e-3 (mamba2-780m) and 4.4e-3
(zamba2-7b) at most.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit
from repro.models import model_forward as jforward
from repro.models import prefill as jprefill
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import make_scenario as jscenario
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.models import (decode_step, init_cache, init_model,
                                model_forward, prefill)
from repro_torch.serve import (ContinuousBatcher, Request, build_serve_step,
                               make_scenario)

ARCHS = ["mamba2-780m", "zamba2-7b"]
TOL = 1e-5
BF16_TOL = 2e-2
MAX_SEQ = 96


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _leaves(tree, prefix=()):
    """{path: leaf} of nested dicts and lists (torch or jax leaves)."""
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, list) else None
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jc = jresolve(request.param, smoke=True)
    tc = resolve(request.param, smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, tree, params_from_repro(tree, tc, device="cpu")


def test_model_forward(models):
    jc, tc, jp, _, tp = models
    toks = np.random.default_rng(9).integers(1, tc.vocab_size, (2, 27))
    got, _ = model_forward(tp, tc, torch.tensor(toks))
    want, _ = jforward(jp, jc, jnp.asarray(toks, jnp.int32))
    _close(got, want)


@pytest.mark.parametrize("T", [21, 3])
def test_prefill_and_decode(models, T):
    """An exact-length prompt (ragged against the chunk, or shorter than
    the conv width), then four decode steps: logits, every cache leaf and
    the lengths against repro."""
    jc, tc, jp, _, tp = models
    rng = np.random.default_rng(10 + T)
    toks = rng.integers(1, tc.vocab_size, (1, T))
    cache = init_cache(tc, 1, MAX_SEQ, dtype=torch.float32, device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, true_len=T)
    jcache = jinit_cache(jc, 1, MAX_SEQ, dtype=jnp.float32)
    want, jst = jprefill(jp, jc, jnp.asarray(toks, jnp.int32), jcache,
                         true_len=T)
    _close(got, want)
    assert st.cache is cache                     # written in place
    for _ in range(4):
        assert st.length.tolist() == np.asarray(jst.length).tolist()
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
        want, jst = jdecode(jp, jc, jnp.asarray(tok, jnp.int32), jst)
        _close(got, want)
    g, w = _leaves(st.cache), _leaves(jst.cache)
    assert set(g) == set(w)
    for path in w:
        _close(g[path], w[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_repro(arch):
    """bf16 weights (repro's init in bf16, through the bridge): the
    no-cache forward, an exact-length prefill and four decode steps, and
    every cache leaf, against repro at BF16_TOL."""
    jc = dataclasses.replace(jresolve(arch, smoke=True), dtype="bfloat16")
    tc = dataclasses.replace(resolve(arch, smoke=True), dtype="bfloat16")
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_repro(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(13).integers(1, tc.vocab_size, (1, 21))
    got, _ = model_forward(tp, tc, torch.tensor(toks))
    want, _ = jforward(jp, jc, jnp.asarray(toks, jnp.int32))
    _close(got, want, BF16_TOL)
    cache = init_cache(tc, 1, MAX_SEQ, dtype=torch.bfloat16, device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, true_len=21)
    jcache = jinit_cache(jc, 1, MAX_SEQ, dtype=jnp.bfloat16)
    want, jst = jprefill(jp, jc, jnp.asarray(toks, jnp.int32), jcache,
                         true_len=21)
    _close(got, want, BF16_TOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
        want, jst = jdecode(jp, jc, jnp.asarray(tok, jnp.int32), jst)
        _close(got, want, BF16_TOL)
    assert st.length.tolist() == np.asarray(jst.length).tolist()
    g, w = _leaves(st.cache), _leaves(jst.cache)
    assert set(g) == set(w)
    for path in w:
        _close(g[path], w[path], BF16_TOL)


def test_batcher_matches_repro(models):
    """Greedy tokens and finish reasons identical to repro's engine on one
    ``mixed`` scenario (staggered arrivals, exact-length prefills, slots
    refilled mid-stream)."""
    jc, tc, jp, _, tp = models
    jreqs = jscenario(jc, kind="mixed", n=5, seed=0, max_seq=MAX_SEQ)
    treqs = make_scenario(tc, kind="mixed", n=5, seed=0, max_seq=MAX_SEQ)
    JBatcher(jp, jc, slots=2, max_seq=MAX_SEQ).run(jreqs)
    _, stats = ContinuousBatcher(tp, tc, slots=2, max_seq=MAX_SEQ,
                                 device="cpu").run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out == [int(x) for x in j.out], t.rid
        assert t.finish_reason == j.finish_reason == "length"
    assert stats["decode_tokens"] == sum(len(r.out) - 1 for r in treqs)


def test_batched_equals_sequential(models):
    """repro's contract: continuous batching is token-identical to serving
    each request alone at batch 1 (the nested cache splices per slot)."""
    _, tc, _, _, tp = models
    reqs = make_scenario(tc, kind="bursty", n=4, seed=3, max_seq=MAX_SEQ)
    clone = lambda r: Request(r.rid, r.prompt,
                              max_new_tokens=r.max_new_tokens,
                              arrival_step=r.arrival_step)
    batched = [clone(r) for r in reqs]
    ContinuousBatcher(tp, tc, slots=3, max_seq=MAX_SEQ,
                      device="cpu").run(batched)
    step1 = build_serve_step(tc, max_seq=MAX_SEQ, slots=1, device="cpu")
    for r, got in zip(reqs, batched):
        alone = clone(r)
        ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ,
                          step=step1).run([alone])
        assert got.out == alone.out
        assert got.finish_reason == alone.finish_reason


def test_bucket_for_is_the_exact_length(models):
    """Recurrent families prefill at the prompt's own length (pad tokens
    would enter the state), as repro's engine does."""
    jc, tc, jp, _, tp = models
    tb = ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ, device="cpu")
    jb = JBatcher(jp, jc, slots=1, max_seq=MAX_SEQ)
    assert tb._bucket_for(13) == jb._bucket_for(13) == 13
    for L in (1, 32, 33, 90):
        assert tb._bucket_for(L) == jb._bucket_for(L) == L


def test_bridge_raises_on_missing_or_left_over_leaf(models):
    _, tc, _, tree, tp = models
    n_port = sum(t.numel() for t in _leaves(tp).values())
    assert n_port == sum(a.size for a in jax.tree.leaves(tree))
    assert tp["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    extra = {**tree, "stray": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        params_from_repro(extra, tc, device="cpu")
    blocks = dict(tree["blocks"])
    blocks["mamba"] = {k: v for k, v in blocks["mamba"].items()
                       if k != "dt_bias"}
    with pytest.raises(KeyError, match="dt_bias"):
        params_from_repro({**tree, "blocks": blocks}, tc, device="cpu")
    if tc.family == "hybrid":
        no_shared = {k: v for k, v in tree.items() if k != "shared_attn"}
        with pytest.raises(KeyError, match="shared_attn"):
            params_from_repro(no_shared, tc, device="cpu")


def test_init_model_matches_the_bridge_template(models):
    """The port's own seeded init has repro's leaves, shapes and dtypes."""
    _, tc, _, _, tp = models
    a = init_model(tc, seed=3, device="cpu")
    b = init_model(tc, seed=3, device="cpu")
    la, lb, lt = _leaves(a), _leaves(b), _leaves(tp)
    assert set(la) == set(lt)
    for path in lt:
        assert la[path].shape == lt[path].shape, path
        assert la[path].dtype == lt[path].dtype, path
        assert torch.equal(la[path], lb[path]), path
