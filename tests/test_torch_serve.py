"""The port's serving tier against ``repro``'s, llama3.2-3b smoke size, f32.

Greedy tokens and finish reasons are held identical: at f32 the two
packages' logits agree to ~1e-7 relative (tests/test_torch_model.py), far
below the gap between the two best tokens of these random-weight models.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import make_scenario as jscenario
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.serve import (ContinuousBatcher, Request, SamplerConfig,
                               build_serve_step, make_scenario,
                               SCENARIO_KINDS)

ARCH = "llama3.2-3b"
MAX_SEQ = 128


@pytest.fixture(scope="module")
def models():
    jc, tc = jresolve(ARCH, smoke=True), resolve(ARCH, smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_repro(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _clone(r):
    return Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens,
                   arrival_step=r.arrival_step)


def _serve(models, kind, slots, n=6):
    jc, tc, jp, tp = models
    jreqs = jscenario(jc, kind=kind, n=n, seed=0, max_seq=MAX_SEQ)
    treqs = make_scenario(tc, kind=kind, n=n, seed=0, max_seq=MAX_SEQ)
    JBatcher(jp, jc, slots=slots, max_seq=MAX_SEQ).run(jreqs)
    _, stats = ContinuousBatcher(tp, tc, slots=slots, max_seq=MAX_SEQ,
                                 device="cpu").run(treqs)
    return jreqs, treqs, stats


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("kind", ["short_chat", "long_context"])
def test_batcher_matches_repro(models, kind, slots):
    jreqs, treqs, stats = _serve(models, kind, slots)
    for j, t in zip(jreqs, treqs):
        assert t.out == [int(x) for x in j.out], t.rid
        assert t.finish_reason == j.finish_reason == "length"
    assert stats["decode_tokens"] == sum(len(r.out) - 1 for r in treqs)
    assert stats["hosting"] == "replicated"
    assert [r["finish_reason"] for r in stats["requests"]] == \
        ["length"] * len(treqs)


@pytest.mark.parametrize("kind", SCENARIO_KINDS)
def test_scenarios_byte_identical(models, kind):
    jc, tc, _, _ = models
    for seed in (0, 7):
        for max_seq in (96, 1024):
            j = jscenario(jc, kind=kind, n=9, seed=seed, max_seq=max_seq)
            t = make_scenario(tc, kind=kind, n=9, seed=seed,
                              max_seq=max_seq)
            assert [(r.rid, r.max_new_tokens, r.arrival_step) for r in t] \
                == [(r.rid, r.max_new_tokens, r.arrival_step) for r in j]
            for a, b in zip(t, j):
                assert a.prompt.dtype == b.prompt.dtype
                assert a.prompt.tobytes() == b.prompt.tobytes()


def test_scenario_rejects_unknown_kind_and_family(models):
    _, tc, _, _ = models
    with pytest.raises(ValueError, match="unknown scenario kind"):
        make_scenario(tc, kind="nope", n=1, seed=0, max_seq=64)
    with pytest.raises(ValueError, match="no serving scenario"):
        make_scenario(dataclasses.replace(tc, family="video"),
                      kind="mixed", n=1, seed=0, max_seq=64)
    # every family of the zoo has a generator; audio requests carry frames
    audio = make_scenario(resolve("whisper-large-v3", smoke=True),
                          kind="mixed", n=1, seed=0, max_seq=64)
    assert audio[0].extra.shape == (16, 64)


def test_admission_and_buckets_match_repro(models):
    jc, tc, jp, tp = models
    jb = JBatcher(jp, jc, slots=2, max_seq=MAX_SEQ)
    tb = ContinuousBatcher(tp, tc, slots=2, max_seq=MAX_SEQ, device="cpu")
    for L in (1, 31, 32, 33, 64, 65, 100, 127, 128):
        assert tb._bucket_for(L) == jb._bucket_for(L), L
    small = ContinuousBatcher(tp, tc, slots=1, max_seq=600, device="cpu")
    assert small._bucket_for(550) == 550       # past the largest bucket
    for prompt_len, new in ((120, 9), (128, 1), (0, 1)):
        prompt = np.arange(1, prompt_len + 1)
        with pytest.raises(ValueError) as te:
            tb.admit(Request("r", prompt, max_new_tokens=new), 0)
        with pytest.raises(ValueError) as je:
            jb.admit(Request("r", prompt, max_new_tokens=new), 0)
        assert str(te.value) == str(je.value)


def test_batched_equals_sequential(models):
    """repro's contract (serve/engine.py): continuous batching is
    token-identical to serving each request alone at batch 1."""
    _, tc, _, tp = models
    reqs = make_scenario(tc, kind="mixed", n=7, seed=3, max_seq=MAX_SEQ)
    step = build_serve_step(tc, max_seq=MAX_SEQ, slots=3, device="cpu")
    batched = [_clone(r) for r in reqs]
    ContinuousBatcher(tp, tc, slots=3, max_seq=MAX_SEQ, step=step).run(
        batched)
    step1 = build_serve_step(tc, max_seq=MAX_SEQ, slots=1, device="cpu")
    for r in reqs:
        alone = _clone(r)
        ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ,
                          step=step1).run([alone])
        got = next(b for b in batched if b.rid == r.rid)
        assert got.out == alone.out and got.finish_reason == \
            alone.finish_reason


def test_eos_and_sampler_limits(models):
    _, tc, _, tp = models
    req = make_scenario(tc, kind="short_chat", n=1, seed=0,
                        max_seq=MAX_SEQ)[0]
    probe = _clone(req)
    ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ,
                      device="cpu").run([probe])
    eos = probe.out[-1]
    first = probe.out.index(eos)          # generation stops at first eos
    r = _clone(req)
    ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ, eos_id=eos,
                      device="cpu").run([r])
    assert r.finish_reason == "eos" and r.out == probe.out[:first + 1]
    # temperature > 0 samples (tests/test_torch_sampling.py holds the
    # tokens to repro's); the budget still ends the request
    sampled = _clone(req)
    ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ, device="cpu",
                      sampler=SamplerConfig(temperature=20.0)).run([sampled])
    assert sampled.finish_reason == "length"
    assert len(sampled.out) == req.max_new_tokens
    assert all(0 <= t < tc.vocab_size for t in sampled.out)
    with pytest.raises(ValueError, match="lane_zero3 serving needs a "
                       "topology"):
        build_serve_step(tc, max_seq=MAX_SEQ, slots=2, hosting="lane_zero3",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown serving hosting"):
        build_serve_step(tc, max_seq=MAX_SEQ, slots=2, hosting="x",
                         device="cpu")
    assert torch.equal(
        ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ,
                          device="cpu").state.length, torch.zeros(1).int())
