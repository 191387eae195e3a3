"""The port's moe, vlm and audio models and their serving against ``repro``.

granite-moe-3b-a800m and dbrx-132b (moe), llava-next-mistral-7b (vlm:
a prefix of projected patch embeddings) and whisper-large-v3 (audio: an
encoder over frame embeddings, cross-attention in every decoder layer)
at smoke size in f32.  Both packages start from ``repro.models.
init_model``'s weights through ``repro_torch.bridge``, and inputs are
numpy draws.  Tolerance 1e-5 of the reference's largest magnitude (at
least 1): only the frameworks' f32 reduction order differs.  Greedy tokens
are held identical: at that agreement the two best logits of these
random-weight models are far apart compared with the error.

In bf16 (``test_bf16_matches_repro``) the tolerance is 2e-2, as for
llama3.2-3b in tests/test_torch_model.py: the two packages round bf16 at
different points, a few bf16 ulps of the logits.  whisper-large-v3 is
compared whole, its encoder included, at that same tolerance, although
``repro``'s encoder runs in f32 under bf16 weights (JAX promotes its f32
frames) and the port's in bf16: at smoke size the departure moves the
logits by no more than the other families' rounding (measured, 1.95e-3
for whisper against 1.95e-3 to 3.9e-3 for the others), so it needs no
looser tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import all_archs
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
from repro_torch.models import decode_step, init_cache, model_forward, \
    prefill
from repro_torch.serve import (ContinuousBatcher, Request, SCENARIO_KINDS,
                               build_serve_step, make_scenario)

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b", "llava-next-mistral-7b",
         "whisper-large-v3"]
TOL = 1e-5
BF16_TOL = 2e-2
MAX_SEQ = 64


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


def _extra(cfg, B, seed):
    """The family's extra embeddings as numpy (B, n, d), or None."""
    n = {"vlm": cfg.vision_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return None
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, cfg.d_model)) * 0.02).astype(np.float32)


def _pair(x):
    """The same numpy array for both packages (None stays None)."""
    return (None, None) if x is None else (jnp.asarray(x), torch.tensor(x))


def _clone(r):
    return Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens,
                   arrival_step=r.arrival_step, extra=r.extra)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jc = jresolve(request.param, smoke=True)
    tc = resolve(request.param, smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, tree, params_from_repro(tree, tc, device="cpu")


def test_model_forward(models):
    jc, tc, jp, _, tp = models
    toks = np.random.default_rng(9).integers(1, tc.vocab_size, (2, 19))
    jx, tx = _pair(_extra(tc, 2, 11))
    got, gaux = model_forward(tp, tc, torch.tensor(toks), extra_embeds=tx)
    want, waux = jforward(jp, jc, jnp.asarray(toks, jnp.int32),
                          extra_embeds=jx)
    _close(got, want)
    _close(gaux, waux)
    if tc.family == "moe":
        assert float(gaux) > 0


def test_prefill_and_decode(models):
    """A 13-token prompt padded to a 24 bucket (``true_len`` < bucket),
    then four decode steps: logits, every cache leaf (``enc_kv`` too) and
    the lengths against repro."""
    jc, tc, jp, _, tp = models
    T, true_len = 24, 13
    rng = np.random.default_rng(10)
    toks = np.zeros((1, T), np.int64)
    toks[0, :true_len] = rng.integers(1, tc.vocab_size, true_len)
    jx, tx = _pair(_extra(tc, 1, 12))
    S = MAX_SEQ + (tc.vision_tokens if tc.family == "vlm" else 0)
    cache = init_cache(tc, 1, S, dtype=torch.float32, device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, extra_embeds=tx,
                      true_len=true_len)
    jcache = jinit_cache(jc, 1, S, dtype=jnp.float32)
    want, jst = jprefill(jp, jc, jnp.asarray(toks, jnp.int32), jcache,
                         extra_embeds=jx, true_len=true_len)
    _close(got, want)
    assert st.cache is cache                     # written in place
    assert (st.enc_kv is None) == (tc.family != "audio")
    for _ in range(4):
        assert st.length.tolist() == np.asarray(jst.length).tolist()
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
        want, jst = jdecode(jp, jc, jnp.asarray(tok, jnp.int32), jst)
        _close(got, want)
    assert st.length.tolist() == np.asarray(jst.length).tolist()
    g = _leaves({"cache": st.cache, "enc_kv": st.enc_kv or {}})
    w = _leaves({"cache": jst.cache, "enc_kv": jst.enc_kv or {}})
    assert set(g) == set(w)
    for path in w:
        _close(g[path], w[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_repro(arch):
    """bf16 weights (repro's init in bf16, through the bridge): the
    no-cache forward, a 13-token prompt padded to a 24 bucket and four
    decode steps, and every cache leaf (``enc_kv`` too), against repro at
    BF16_TOL."""
    jc = dataclasses.replace(jresolve(arch, smoke=True), dtype="bfloat16")
    tc = dataclasses.replace(resolve(arch, smoke=True), dtype="bfloat16")
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_repro(jax.tree.map(np.asarray, jp), tc, device="cpu")
    T, true_len = 24, 13
    toks = np.zeros((1, T), np.int64)
    toks[0, :true_len] = np.random.default_rng(14).integers(
        1, tc.vocab_size, true_len)
    jx, tx = _pair(_extra(tc, 1, 15))
    got, _ = model_forward(tp, tc, torch.tensor(toks[:, :true_len]),
                           extra_embeds=tx)
    want, _ = jforward(jp, jc, jnp.asarray(toks[:, :true_len], jnp.int32),
                       extra_embeds=jx)
    _close(got, want, BF16_TOL)
    S = MAX_SEQ + (tc.vision_tokens if tc.family == "vlm" else 0)
    cache = init_cache(tc, 1, S, dtype=torch.bfloat16, device="cpu")
    got, st = prefill(tp, tc, torch.tensor(toks), cache, extra_embeds=tx,
                      true_len=true_len)
    jcache = jinit_cache(jc, 1, S, dtype=jnp.bfloat16)
    want, jst = jprefill(jp, jc, jnp.asarray(toks, jnp.int32), jcache,
                         extra_embeds=jx, true_len=true_len)
    _close(got, want, BF16_TOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        got, st = decode_step(tp, tc, torch.tensor(tok, dtype=torch.long),
                              st)
        want, jst = jdecode(jp, jc, jnp.asarray(tok, jnp.int32), jst)
        _close(got, want, BF16_TOL)
    assert st.length.tolist() == np.asarray(jst.length).tolist()
    g = _leaves({"cache": st.cache, "enc_kv": st.enc_kv or {}})
    w = _leaves({"cache": jst.cache, "enc_kv": jst.enc_kv or {}})
    assert set(g) == set(w)
    for path in w:
        _close(g[path], w[path], BF16_TOL)


def test_batcher_matches_repro(models):
    """Greedy tokens and finish reasons identical to repro's engine on one
    ``mixed`` scenario (staggered arrivals, bucketed prefills, the vlm
    prefix in every bound, slots refilled mid-stream)."""
    jc, tc, jp, _, tp = models
    max_seq = MAX_SEQ + (tc.vision_tokens if tc.family == "vlm" else 0)
    jreqs = jscenario(jc, kind="mixed", n=5, seed=0, max_seq=max_seq)
    treqs = make_scenario(tc, kind="mixed", n=5, seed=0, max_seq=max_seq)
    JBatcher(jp, jc, slots=2, max_seq=max_seq).run(jreqs)
    _, stats = ContinuousBatcher(tp, tc, slots=2, max_seq=max_seq,
                                 device="cpu").run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out == [int(x) for x in j.out], t.rid
        assert t.finish_reason == j.finish_reason == "length"
    assert stats["decode_tokens"] == sum(len(r.out) - 1 for r in treqs)


def test_batched_equals_sequential(models):
    """repro's contract: continuous batching is token-identical to serving
    each request alone at batch 1 (``enc_kv`` splices per slot)."""
    _, tc, _, _, tp = models
    max_seq = MAX_SEQ + (tc.vision_tokens if tc.family == "vlm" else 0)
    reqs = make_scenario(tc, kind="bursty", n=4, seed=3, max_seq=max_seq)
    batched = [_clone(r) for r in reqs]
    ContinuousBatcher(tp, tc, slots=3, max_seq=max_seq,
                      device="cpu").run(batched)
    step1 = build_serve_step(tc, max_seq=max_seq, slots=1, device="cpu")
    for r, got in zip(reqs, batched):
        alone = _clone(r)
        ContinuousBatcher(tp, tc, slots=1, max_seq=max_seq,
                          step=step1).run([alone])
        assert got.out == alone.out
        assert got.finish_reason == alone.finish_reason


def test_admission_with_prefix_matches_repro(models):
    """Buckets are capped at ``max_seq - prefix`` and admission counts the
    vlm prefix, with repro's messages."""
    jc, tc, jp, _, tp = models
    prefix = tc.vision_tokens if tc.family == "vlm" else 0
    max_seq = MAX_SEQ + prefix
    jb = JBatcher(jp, jc, slots=1, max_seq=max_seq)
    tb = ContinuousBatcher(tp, tc, slots=1, max_seq=max_seq, device="cpu")
    for L in (1, 31, 32, 33, 60, 64):
        assert tb._bucket_for(L) == jb._bucket_for(L), L
    extra = _extra(tc, 1, 0)
    extra = None if extra is None else extra[0]
    for prompt_len, new in ((60, 5), (64, 1), (0, 1)):
        prompt = np.arange(1, prompt_len + 1)
        with pytest.raises(ValueError) as te:
            tb.admit(Request("r", prompt, new, extra=extra), 0)
        with pytest.raises(ValueError) as je:
            jb.admit(Request("r", prompt, new, extra=extra), 0)
        assert str(te.value) == str(je.value)
    if tc.family in ("vlm", "audio"):
        with pytest.raises(ValueError, match="Request.extra"):
            tb.admit(Request("r", np.arange(1, 5), 2), 0)


def test_splice_writes_every_leaf_into_its_slot(models):
    """A batch-1 prefill spliced into slot 1 of 3: every cache leaf,
    ``enc_kv`` included, and the length land in that slot, and the other
    slots stay zero."""
    _, tc, _, _, tp = models
    max_seq = MAX_SEQ + (tc.vision_tokens if tc.family == "vlm" else 0)
    step = build_serve_step(tc, max_seq=max_seq, slots=3, device="cpu")
    toks = np.random.default_rng(13).integers(1, tc.vocab_size, (1, 32))
    _, st1 = step.prefill(tp, toks, 20, _extra(tc, 1, 14))
    state = step.splice(step.init_state(), st1, 1)
    big = _leaves({"cache": state.cache, "enc_kv": state.enc_kv or {}})
    small = _leaves({"cache": st1.cache, "enc_kv": st1.enc_kv or {}})
    assert set(big) == set(small) and \
        any(p[0] == "enc_kv" for p in big) == (tc.family == "audio")
    for path, leaf in big.items():
        assert torch.equal(leaf[:, 1], small[path][:, 0]), path
        assert not leaf[:, [0, 2]].any(), path
    assert state.length.tolist() == [0, int(st1.length[0]), 0]


@pytest.mark.parametrize("kind", SCENARIO_KINDS)
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_scenarios_with_extras_byte_identical(arch, kind):
    jc, tc = jresolve(arch, smoke=True), resolve(arch, smoke=True)
    for seed in (0, 7):
        for max_seq in (40, 1024):
            j = jscenario(jc, kind=kind, n=7, seed=seed, max_seq=max_seq)
            t = make_scenario(tc, kind=kind, n=7, seed=seed,
                              max_seq=max_seq)
            assert [(r.rid, r.max_new_tokens, r.arrival_step) for r in t] \
                == [(r.rid, r.max_new_tokens, r.arrival_step) for r in j]
            for a, b in zip(t, j):
                assert a.prompt.tobytes() == b.prompt.tobytes()
                assert a.extra.dtype == b.extra.dtype == np.float32
                assert a.extra.tobytes() == b.extra.tobytes()


@pytest.mark.parametrize("arch", all_archs())
def test_bridge_consumes_every_leaf(arch):
    """Every repro leaf of every arch's smoke config lands in the port's
    parameters (the nested encoder stack too), and a missing or stray
    leaf raises."""
    jc, tc = jresolve(arch, smoke=True), resolve(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
    params = params_from_repro(tree, tc, device="cpu")
    assert sum(t.numel() for t in _leaves(params).values()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    with pytest.raises(ValueError, match="not consumed"):
        params_from_repro({**tree, "stray": np.zeros(3, np.float32)}, tc,
                          device="cpu")
    with pytest.raises(KeyError, match="final_norm"):
        params_from_repro({**tree, "final_norm": {}}, tc, device="cpu")
    if tc.family == "audio":
        enc = dict(tree["encoder"])
        enc["blocks"] = jax.tree.map(lambda a: a[:1], enc["blocks"])
        with pytest.raises(ValueError, match="stacks 1 layers"):
            params_from_repro({**tree, "encoder": enc}, tc, device="cpu")
