"""The port's seeded sampler and sampled serving against ``repro``'s.

``repro_torch.serve.sampling`` draws with the bit-exact threefry of
``serve.prng``, so its tokens are held identical to ``repro``'s
``sample_token`` (run under ``jax.jit`` on the CPU, as ``repro``'s engine
runs it) over a fixed sweep of (seed, rid, position, temperature, top_p).
The softmax, the nucleus sums and the ``log`` round in another order in
the two libraries, by an ulp or so; a token could differ only where two
candidates of ``log p + g`` lie within a few ulps, which the sweep's
random logits never give.  The engine is held to repro's sampled engine
(llama3.2-3b smoke size, f32) and to its own contracts: batched ==
sequential, and the same stream on a replay.  The smoke model's tied
embedding gives peaked logits (up to ~64), so below a temperature of ~8
every draw is the greedy token; the engine tests sample at 20, where the
streams differ from greedy.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import make_scenario as jscenario
from repro.serve import sampling as jsampling
from repro.serve.engine import _int_rid as j_int_rid
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.serve import (ContinuousBatcher, Request, SamplerConfig,
                               build_serve_step, make_scenario, sampling)
from repro_torch.serve.engine import _int_rid

TEMPS = (0.0, 0.5, 0.8, 1.0, 1.7)
TOP_PS = (1.0, 0.9, 0.5, 0.05)
RIDS = (0, 7, 2**31 + 5, 123456789)
POSITIONS = (0, 3, 17, 1000)
ARCH = "llama3.2-3b"
MAX_SEQ = 96


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("V", [256, 32000])
def test_sample_token_matches_repro(V, seed):
    """Four rows a configuration, each with its own (rid, position), drawn
    in one batched call; repro draws each row alone."""
    rng = np.random.default_rng([V, seed])
    for temp in TEMPS:
        for top_p in TOP_PS:
            js = jsampling.SamplerConfig(temperature=temp, top_p=top_p,
                                         seed=seed)
            draw = jax.jit(lambda row, rid, pos:
                           jsampling.sample_token(row, js, rid, pos))
            rows = (rng.standard_normal((4, V)) * 3).astype(np.float32)
            want = [int(draw(jnp.asarray(rows[i]),
                             jnp.asarray(RIDS[i], jnp.uint32),
                             jnp.asarray(POSITIONS[i], jnp.uint32)))
                    for i in range(4)]
            ts = SamplerConfig(temperature=temp, top_p=top_p, seed=seed)
            got = sampling.sample_token(torch.tensor(rows), ts, list(RIDS),
                                        list(POSITIONS))
            assert got.tolist() == want, (temp, top_p)
            one = sampling.sample_token(torch.tensor(rows[2]), ts, RIDS[2],
                                        POSITIONS[2])
            assert one.ndim == 0 and int(one) == want[2]


@pytest.mark.parametrize("seed,rid,pos", [(0, 0, 0), (5, 2**32 - 1, 9),
                                          (2**33 + 1, 17, 2**31)])
def test_request_key_matches_repro(seed, rid, pos):
    want = np.asarray(jax.random.key_data(jsampling.request_key(
        seed, jnp.asarray(rid, jnp.uint32), jnp.asarray(pos, jnp.uint32))))
    assert sampling.request_key(seed, rid, pos).tolist() == \
        want.astype(np.int64).tolist()
    keys = sampling.request_key(seed, [rid, rid + 1], [pos, pos])
    assert keys.shape == (2, 2) and keys[0].tolist() == \
        want.astype(np.int64).tolist()


@pytest.mark.parametrize("top_p", [0.05, 0.25, 0.5, 0.5000001, 0.75, 0.9,
                                   1.0])
def test_top_p_renormalize_matches_repro(top_p):
    """Ties keep their index order (stable sort), a prefix whose exclusive
    mass equals top_p exactly is cut there, and the top-1 token is always
    kept."""
    rows = np.array([
        [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],      # four-way tie
        [0.1, 0.4, 0.1, 0.4, 0.0, 0.0],          # pairs of ties
        [0.5, 0.25, 0.125, 0.125, 0.0, 0.0],     # boundaries at exact sums
        [0.96, 0.01, 0.01, 0.01, 0.01, 0.0],     # the top-1 alone past p
    ], np.float32)
    rng = np.random.default_rng(0)
    rand = rng.dirichlet(np.ones(6), size=4).astype(np.float32)
    for probs in (rows, rand):
        want = np.asarray(jsampling.top_p_renormalize(jnp.asarray(probs),
                                                      top_p))
        got = sampling.top_p_renormalize(torch.tensor(probs), top_p).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (got[np.arange(4), probs.argmax(-1)] > 0).all()


def test_greedy_is_the_first_argmax_and_reads_no_key():
    logits = torch.tensor([[1.0, 3.0, 3.0, -2.0], [0.0, 0.0, 0.0, 0.0]])
    for s in (None, sampling.GREEDY, SamplerConfig(temperature=-1.0)):
        assert sampling.sample_token(logits, s).tolist() == [1, 0]
        assert sampling.sample_token(logits, s, rid="not read",
                                     position=None).tolist() == [1, 0]
    with pytest.raises(ValueError, match="keys for logits rows"):
        sampling.sample_token(logits, SamplerConfig(temperature=1.0),
                              [0, 1, 2], [0, 0, 0])


def test_int_rid_matches_repro():
    for rid in (0, 5, 2**32 + 3, -1, np.int64(12), "req-7", ("a", 1)):
        assert _int_rid(rid) == j_int_rid(rid), rid


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jc, tc = jresolve(ARCH, smoke=True), resolve(ARCH, smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_repro(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _clone(r):
    return Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens,
                   arrival_step=r.arrival_step)


@pytest.mark.parametrize("temp,top_p,seed", [(0.8, 0.9, 3), (20.0, 0.95, 0),
                                             (20.0, 1.0, 5)])
def test_sampled_batcher_matches_repro(models, temp, top_p, seed):
    jc, tc, jp, tp = models
    jreqs = jscenario(jc, kind="mixed", n=6, seed=1, max_seq=MAX_SEQ)
    treqs = make_scenario(tc, kind="mixed", n=6, seed=1, max_seq=MAX_SEQ)
    JBatcher(jp, jc, slots=3, max_seq=MAX_SEQ,
             sampler=jsampling.SamplerConfig(temperature=temp, top_p=top_p,
                                             seed=seed)).run(jreqs)
    ContinuousBatcher(tp, tc, slots=3, max_seq=MAX_SEQ, device="cpu",
                      sampler=SamplerConfig(temperature=temp, top_p=top_p,
                                            seed=seed)).run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out == [int(x) for x in j.out], t.rid
        assert t.finish_reason == j.finish_reason


def test_sampled_batched_equals_sequential_and_replays(models):
    """A sampled stream is keyed by (seed, rid, position) alone: the same
    tokens at 3 slots as alone at batch 1, on a replay, and different
    from greedy and from another seed."""
    _, tc, _, tp = models
    sampler = SamplerConfig(temperature=20.0, top_p=0.95, seed=11)
    reqs = make_scenario(tc, kind="bursty", n=7, seed=4, max_seq=MAX_SEQ)
    for r in reqs[::2]:
        r.rid = f"user-{r.rid}"              # crc32-hashed rids too
    step = build_serve_step(tc, max_seq=MAX_SEQ, slots=3, device="cpu")
    runs = []
    for s in (sampler, sampler, None,
              SamplerConfig(temperature=20.0, top_p=0.95, seed=12)):
        batched = [_clone(r) for r in reqs]
        ContinuousBatcher(tp, tc, slots=3, max_seq=MAX_SEQ, step=step,
                          sampler=s).run(batched)
        runs.append([b.out for b in batched])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2] and runs[0] != runs[3]
    step1 = build_serve_step(tc, max_seq=MAX_SEQ, slots=1, device="cpu")
    for r, out in zip(reqs, runs[0]):
        alone = _clone(r)
        ContinuousBatcher(tp, tc, slots=1, max_seq=MAX_SEQ, step=step1,
                          sampler=sampler).run([alone])
        assert alone.out == out, r.rid
