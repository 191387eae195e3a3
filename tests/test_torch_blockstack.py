"""The port's sharded block stack (``models/blockstack.py``) against
``repro.models.blockstack``, on the CPU.

* ``tests/test_blockstack.py``'s cases, against ``repro``: the
  ``StackLayout`` of every family's layer stack and extras (row size,
  decay, the f32 row matrix, each row's unflatten, the decay mask), its errors, ``shard_stack``'s (L, B, n·N, s) masters and B,
  the registered families and their specs, ``split_params``,
  ``family_smoke_archs``, ``scan_stack``'s three modes on a toy stack,
  a single layer, and the blocking/regather refusal at both levels.
* On a 4-rank gloo world (2 × 2), each family's smoke model from
  ``repro``'s weights: the loss and this rank's shard-row gradients
  through a ``ShardedStack`` are the same in the prefetch, blocking and
  regather modes and equal the replicated model's (each rank takes the
  same batch, so the reduce-scattered gradient is 4× the replicated
  stripe, exactly); the gathers number L in the forward and L more in
  the backward under regather.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resolve as jresolve
from repro.models import blockstack as jbs
from repro.models import init_model as jinit
from repro.core import costmodel as jcm
from repro_torch import _tree
from repro_torch.bridge import params_from_repro
from repro_torch.configs import RunConfig, resolve
from repro_torch.core import costmodel as tcm
from repro_torch.launch import mesh
from repro_torch.models import blockstack as tbs

import _torch_dist_workers as workers
from _torch_dist_workers import save_tree

FAMILY_ARCHS = {"dense": "llama3.2-3b", "moe": "granite-moe-3b-a800m",
                "ssm": "mamba2-780m", "hybrid": "zamba2-7b",
                "vlm": "llava-next-mistral-7b", "audio": "whisper-large-v3"}


@pytest.fixture
def repro_hw():
    """``repro``'s active constants as the port's, for one test."""
    j = jcm.get_hw()
    prev = tcm.set_hw(tcm.HW(
        peak_flops_bf16=j.peak_flops_bf16, hbm_bw=j.hbm_bw, node_bw=j.ici_bw,
        lane_bw=j.dcn_bw, gpus_per_host=j.chips_per_host,
        alpha_node=j.alpha_ici, alpha_lane=j.alpha_dcn))
    try:
        yield
    finally:
        tcm.set_hw(prev)


@pytest.fixture(scope="module")
def zoo():
    made = {}

    def get(arch):
        if arch not in made:
            tree = jax.tree.map(np.asarray, jinit(
                jax.random.PRNGKey(0), jresolve(arch, smoke=True)))
            made[arch] = (tree, params_from_repro(
                tree, resolve(arch, smoke=True), device="cpu"))
        return made[arch]
    return get


def _split(arch, zoo):
    tree, port = zoo(arch)
    jspec = jbs.block_stack_spec(jresolve(arch, smoke=True))
    tspec = tbs.block_stack_spec(resolve(arch, smoke=True))
    return jbs.split_params(jspec, tree), tbs.split_params(tspec, port)


# ---------------------------------------------------------------------------
# StackLayout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
@pytest.mark.parametrize("stacked", [True, False])
def test_stack_layout_matches_repro(zoo, family, stacked):
    (jstack, jext, _), (tstack, text, _) = _split(FAMILY_ARCHS[family], zoo)
    jt, tt = (jstack, tstack) if stacked else (jext, text)
    jlay = jbs.stack_layout(jt, stacked=stacked)
    tlay = tbs.stack_layout(tt, stacked=stacked)
    assert (tlay.row_elems, tlay.length) == (jlay.row_elems, jlay.length)
    if not (family == "audio" and not stacked):
        assert tlay.decay == jlay.decay
        assert [s for s, _ in tlay.metas] == [s for s, _ in jlay.metas]
    # (whisper's extras hold its encoder stack: one (Le, ...) leaf in
    # repro, Le consecutive leaves here; the mask and the matrix below
    # compare them element by element)
    mat = tlay.flatten(tt, pad_to=8)
    np.testing.assert_array_equal(
        mat.numpy(), np.asarray(jlay.flatten(jt, pad_to=8)))
    np.testing.assert_array_equal(
        tlay.decay_mask(mat.shape[1]).numpy(),
        np.asarray(jlay.decay_mask(mat.shape[1])))
    for r, row in enumerate(tt if stacked else [tt]):
        back = tlay.unflatten_row(mat[r])
        assert [tuple(t.shape) for t in _tree.leaves(back)] == \
            [tuple(t.shape) for t in _tree.leaves(row)]
        for a, b in zip(_tree.leaves(back), _tree.leaves(row)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def test_stack_layout_casts_to_each_leafs_dtype():
    t = [{"w": torch.arange(8, dtype=torch.float32).reshape(4, 2) + 4 * L,
          "b": torch.arange(5, dtype=torch.bfloat16)} for L in range(3)]
    lay = tbs.stack_layout(t, stacked=True)
    assert lay.row_elems == 13 and lay.length == 3
    assert lay.decay == (True, True)       # the stack's L axis: rank >= 2
    mat = lay.flatten(t, pad_to=8)
    assert mat.shape == (3, 16) and mat.dtype == torch.float32
    back = lay.unflatten_row(mat[1])
    assert back["b"].dtype == torch.bfloat16 and back["w"].dtype \
        == torch.float32
    assert torch.equal(back["w"], t[1]["w"])
    assert torch.equal(lay.flatten_row(t[1], pad_to=8), mat[1])
    ext = {"embed": {"w": torch.ones(7, 2)}, "norm": torch.ones(2)}
    lay = tbs.stack_layout(ext, stacked=False)
    assert lay.decay == (True, False)
    mask = lay.decay_mask(20)
    assert mask[:14].all() and not mask[14:].any()


def test_stack_layout_errors():
    with pytest.raises(ValueError, match="empty"):
        tbs.stack_layout([], stacked=True)
    with pytest.raises(ValueError, match="empty"):
        tbs.stack_layout({}, stacked=False)
    with pytest.raises(ValueError, match="disagree"):
        tbs.stack_layout([{"a": torch.zeros(3)}, {"a": torch.zeros(4)}],
                         stacked=True)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_shard_stack_matches_repro(zoo, family, repro_hw):
    (jstack, jext, _), (tstack, text, _) = _split(FAMILY_ARCHS[family], zoo)
    for pre in (0, 3, -1):
        for jt, tt, stacked in ((jstack, tstack, True),
                                (jext, text, False)):
            jm, jB = jbs.shard_stack(jt, 2, 2, pre, stacked=stacked)
            tm, tB = tbs.shard_stack(tt, 2, 2, pre, stacked=stacked)
            assert tB == jB
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for row in (13, 4096, 1 << 20):
        for pre in (0, 3, -1):
            assert tbs.resolve_prefetch_blocks(row, 2, 2, pre) \
                == jbs.resolve_prefetch_blocks(row, 2, 2, pre)
            assert tbs.resolve_extras_prefetch_blocks(row, 2, 2, pre) \
                == jbs.resolve_extras_prefetch_blocks(row, 2, 2, pre)


# ---------------------------------------------------------------------------
# BlockSpec registry
# ---------------------------------------------------------------------------

def test_block_stack_registry_matches_repro():
    assert tbs.block_stack_families() == jbs.block_stack_families()
    for fam, arch in FAMILY_ARCHS.items():
        j = jbs.block_stack_spec(jresolve(arch, smoke=True))
        t = tbs.block_stack_spec(resolve(arch, smoke=True))
        assert (t.family, t.stack_key, t.replicated_keys,
                t.needs_extra_embeds) == (j.family, j.stack_key,
                                          j.replicated_keys,
                                          j.needs_extra_embeds) \
            == (fam, "blocks", ("shared_attn",) if fam == "hybrid" else (),
                fam in ("vlm", "audio"))


def test_block_stack_spec_unknown_family():
    cfg = dataclasses.replace(resolve("llama3.2-3b", smoke=True),
                              family="holographic")
    with pytest.raises(ValueError, match="no registered block_stack"):
        tbs.block_stack_spec(cfg)


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_split_params_matches_repro(zoo, family):
    (jstack, jext, jrepl), (tstack, text, trepl) = \
        _split(FAMILY_ARCHS[family], zoo)
    assert sorted(text) == sorted(jext) and sorted(trepl) == sorted(jrepl)
    assert len(tstack) == jax.tree.leaves(jstack)[0].shape[0]
    with pytest.raises(ValueError, match="no 'blocks'"):
        tbs.split_params(tbs.block_stack_spec(resolve("llama3.2-3b",
                                                      smoke=True)),
                         {"embed": torch.zeros(3)})


def test_family_smoke_archs_match_repro():
    assert tbs.family_smoke_archs() == jbs.family_smoke_archs()
    assert tbs.family_smoke_archs(driver_trainable_only=True) \
        == jbs.family_smoke_archs(driver_trainable_only=True)


# ---------------------------------------------------------------------------
# scan_stack on a toy stack: the three modes agree in value AND gradient
# ---------------------------------------------------------------------------

def _toy_stack(L=4, D=6):
    rng = np.random.default_rng(0)
    shards = rng.normal(size=(L, D)).astype(np.float32)
    jgather = lambda x: {"w": x * 2.0}

    def jbody(h, lp, i):
        scale = jnp.where(i % 2 == 0, 1.0, 0.5)
        h = h + scale * jnp.sum(lp["w"]) * h
        return h, jnp.sum(lp["w"]) * 0.1

    def tbody(h, lp, i):
        scale = 1.0 if i % 2 == 0 else 0.5
        h = h + scale * lp["w"].sum() * h
        return h, lp["w"].sum() * 0.1
    return shards, jgather, jbody, tbody


@pytest.mark.parametrize("mode", ["prefetch", "blocking", "regather"])
def test_scan_stack_modes_match_repro(mode):
    shards, jgather, jbody, tbody = _toy_stack()
    kw = dict(prefetch=mode != "blocking", regather=mode == "regather")

    def jloss(sh):
        h, aux = jbs.scan_stack(jbs.ShardedStack(sh, jgather, **kw),
                                jnp.ones((3,), jnp.float32), jbody)
        return jnp.sum(h) + jnp.sum(aux)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(shards))
    rows = [torch.tensor(r, requires_grad=True) for r in shards]
    h, aux = tbs.scan_stack(
        tbs.ShardedStack(rows, lambda x: {"w": x * 2.0}, **kw),
        torch.ones(3), tbody)
    assert aux.shape == (4,)
    loss = h.sum() + aux.sum()
    grads = torch.autograd.grad(loss, rows)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(torch.stack(grads).numpy(), np.asarray(jg),
                               rtol=1e-5)


def test_scan_stack_single_layer():
    shards, _, _, tbody = _toy_stack(L=1)
    h, aux = tbs.scan_stack(
        tbs.ShardedStack(torch.from_numpy(shards), lambda x: {"w": x}),
        torch.ones(3), tbody)
    assert aux.shape == (1,)


def test_regather_blocking_mutually_exclusive():
    with pytest.raises(ValueError, match="blocking negative control"):
        tbs.ShardedStack(torch.zeros(2, 4), lambda x: x, prefetch=False,
                         regather=True)
    from repro_torch.comm import LaneComm
    from repro_torch.core.lane import LaneTopology
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamWConfig
    topo = LaneTopology(2, 2, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None, node_ranks=[0, 1],
                        lane_ranks=[0, 2], ranks=[0, 1, 2, 3])
    run = RunConfig(model=resolve("llama3.2-3b", smoke=True),
                    gradsync="lane_zero3", fsdp_prefetch=-1,
                    fsdp_regather=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_train_step(run, AdamWConfig(), LaneComm(topo), single=False)
    with pytest.raises(ValueError, match="distinct lane and node"):
        build_train_step(dataclasses.replace(run, fsdp_regather=False),
                         AdamWConfig(), LaneComm(topo), single=True)


# ---------------------------------------------------------------------------
# real models through the sharded stack, on a 4-rank gloo world
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ["dense", "moe", "ssm", "hybrid"]


@pytest.fixture(scope="module")
def stacked_runs(tmp_path_factory, zoo):
    tmp = tmp_path_factory.mktemp("blockstack")
    runs = []
    for fam in TRAIN_FAMILIES:
        arch = FAMILY_ARCHS[fam]
        path = tmp / f"{arch}.npz"
        save_tree(path, zoo(arch)[0])
        runs.append((arch, str(path)))
    return mesh.spawn(workers.blockstack_rank, 4, runs)


@pytest.mark.parametrize("family", TRAIN_FAMILIES)
def test_scan_stack_modes_agree_on_models(stacked_runs, family):
    arch = FAMILY_ARCHS[family]
    L = resolve(arch, smoke=True).num_layers
    for rank in stacked_runs:
        res = rank[arch]
        want_loss, want_rows = res["replicated"]
        for mode in ("prefetch", "blocking", "regather"):
            loss, grads, fwd, total = res[mode]
            assert loss == want_loss, (mode, loss, want_loss)
            assert len(grads) == L
            for g, w in zip(grads, want_rows):
                np.testing.assert_array_equal(g, 4 * w, err_msg=mode)
            assert fwd == L
            assert total == (2 * L if mode == "regather" else L), mode
