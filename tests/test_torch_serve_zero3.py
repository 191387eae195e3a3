"""``lane_zero3`` serving across ranks against replicated hosting and
``repro``.

One 4-rank gloo world (2 x 2, ``_torch_dist_workers.serve_zero3_rank``)
serves ``repro``'s seed-0 smoke weights with slots 8, each process
holding 1/4 of the layer stack and the extras and owning 2 slots, for
the cases of ``repro.testing.serve_cases``: llama3.2-3b ``short_chat``
and ``bursty``, mamba2-780m ``mixed``, granite-moe-3b-a800m, llava and
whisper ``short_chat``, llama with the blocking gather and with the
``native`` kv_splice.  Every request's tokens equal replicated
hosting's (4 slots) and ``repro``'s replicated tokens.  Beside them:
seeded sampling, replicated at 2 slots against lane_zero3 at 8 (``repro``'s
T = 0.8, and T = 20, where the random models' draws depart from
greedy); serving from the checkpoints of a 2-step native, lane_zero1
and lane_zero3 training run through ``load_serve_params``; ``kv_splice``
``native`` against ``lane`` bit for bit on every slot; exactly L layer
gathers per prefill and per decode (on one rank too); and the hybrid
family and ``slots % p`` raising as ``repro`` does.
"""
import jax
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import SamplerConfig as JSampler
from repro.serve import make_scenario as jscenario
from repro_torch.launch import mesh

import _torch_dist_workers as workers
from _torch_dist_workers import SERVE_MAX_SEQ, save_tree

CASES = [
    # name, arch, scenario kind, prefetch_blocks, kv_strategy
    ("llama3.2-3b__short_chat", "llama3.2-3b", "short_chat", 0, "lane"),
    ("llama3.2-3b__bursty", "llama3.2-3b", "bursty", 0, "lane"),
    ("mamba2-780m__mixed", "mamba2-780m", "mixed", 0, "lane"),
    ("granite-moe-3b-a800m__short_chat", "granite-moe-3b-a800m",
     "short_chat", 0, "lane"),
    ("llava-next-mistral-7b__short_chat", "llava-next-mistral-7b",
     "short_chat", 0, "lane"),
    ("whisper-large-v3__short_chat", "whisper-large-v3", "short_chat", 0,
     "lane"),
    ("llama3.2-3b__blocking_prefetch", "llama3.2-3b", "short_chat", -1,
     "lane"),
    ("llama3.2-3b__kv_native", "llama3.2-3b", "short_chat", 0, "native"),
]
ARCHS = sorted({c[1] for c in CASES})
SAMPLERS = [(0.8, 0.9, 11), (20.0, 0.9, 11)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_zero3")
    params, paths = {}, {}
    for arch in ARCHS:
        params[arch] = jinit(jax.random.PRNGKey(0), jresolve(arch, smoke=True))
        paths[arch] = str(tmp / f"{arch}.npz")
        save_tree(paths[arch], jax.tree.map(np.asarray, params[arch]))
    return tmp, params, paths


@pytest.fixture(scope="module")
def world(weights):
    tmp, _, paths = weights
    return mesh.spawn(workers.serve_zero3_rank, 4, paths, CASES, SAMPLERS,
                      str(tmp / "ckpt"))


def _repro_tokens(params, arch, kind, *, slots=4, sampler=None):
    cfg = jresolve(arch, smoke=True)
    reqs = jscenario(cfg, kind=kind, n=6, seed=1, max_seq=SERVE_MAX_SEQ)
    done, _ = JBatcher(params, cfg, slots=slots, max_seq=SERVE_MAX_SEQ,
                       sampler=sampler).run(reqs)
    return {r.rid: [int(t) for t in r.out] for r in done}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_zero3_tokens_match_replicated_and_repro(weights, world, case):
    name, arch, kind, _, kv = case
    _, params, _ = weights
    want = _repro_tokens(params[arch], arch, kind)
    for rank in world:
        rep, z3, hosting, cells = rank["tokens"][name]
        assert hosting == "lane_zero3"
        assert cells["kv"] == ("kv_splice", kv)
        assert rep == want
        assert z3 == rep, {k: (rep[k], z3[k]) for k in rep if rep[k] != z3[k]}


@pytest.mark.parametrize("temperature", [s[0] for s in SAMPLERS])
def test_sampled_replay(weights, world, temperature):
    _, params, _ = weights
    s = next(x for x in SAMPLERS if x[0] == temperature)
    want = _repro_tokens(params["llama3.2-3b"], "llama3.2-3b", "short_chat",
                         slots=2, sampler=JSampler(temperature=s[0],
                                                   top_p=s[1], seed=s[2]))
    for rank in world:
        rep, z3 = rank["sampled"][temperature]
        assert rep == want and z3 == rep


@pytest.mark.parametrize("gradsync,kind", [
    ("native", "replicated"), ("lane_zero1", "zero1"),
    ("lane_zero3", "zero3")])
def test_serving_from_checkpoint(world, gradsync, kind):
    for rank in world:
        step, rep, z3, got_kind = rank["ckpt"][gradsync]
        assert step == 2 and got_kind == kind
        assert z3 == rep
    # every layout trains the same model: the same tokens from each
    assert world[0]["ckpt"]["lane_zero3"][1] == world[0]["ckpt"][gradsync][1]


def test_kv_splice_native_matches_lane(world):
    for g, rank in enumerate(world):
        for (dt, slot), (res, small) in rank["splice"].items():
            np.testing.assert_array_equal(res["native"], res["lane"])
            owner, local = divmod(slot, 2)
            if owner == g:
                root = world[0]["splice"][dt, slot][1]
                np.testing.assert_array_equal(res["lane"][:, local],
                                              root[:, 0])


def test_exactly_L_gathers_per_call(world):
    for rank in world:
        L, prefill_g, total, shape = rank["gathers"]
        assert prefill_g == L and total == 2 * L
        assert shape[0] == 8                 # every slot's logits


def test_exactly_L_gathers_on_one_rank():
    L, n1, n2, rep, z3 = mesh.spawn(workers.serve_gathers_rank, 1,
                                    "mamba2-780m")[0]
    assert (n1, n2) == (L, 2 * L)
    assert z3 == rep


def test_hybrid_and_slots_raise(world):
    errors = world[0]["errors"]
    assert "hybrid family cannot serve from 1/p-sharded weights" in \
        errors["hybrid"]
    assert "slots=6 must be divisible by the chip count p=4" in \
        errors["slots"]
