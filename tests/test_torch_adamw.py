"""The port's AdamW (``repro_torch.optim``) against ``repro.optim.adamw``.

Trees go between the packages through ``repro_torch.bridge``: the port
keeps layers as a list, ``repro`` stacks them along a leading L axis.
Tolerances: ``cosine_lr`` and ``global_norm`` 1e-6 relative (f32, one or
two roundings apart); updated parameters and moments 1e-6 of the leaf's
largest magnitude (at least 1), where only the order of f32 operations
differs (a fused multiply-add here and there).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.optim import adamw as jadamw
from repro_torch import _tree
from repro_torch.bridge import params_from_repro, params_to_repro
from repro_torch.configs import resolve
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_lr, global_norm)

TOL = 1e-6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _jcfg(cfg: AdamWConfig):
    return jadamw.AdamWConfig(**dataclasses.asdict(cfg))


_jupdate = jax.jit(jadamw.adamw_update, static_argnums=0)


@pytest.mark.parametrize("cfg", [
    AdamWConfig(), AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20),
    AdamWConfig(warmup_steps=0, total_steps=1, min_lr_frac=0.0)],
    ids=["default", "train_main", "no_warmup"])
def test_cosine_lr_matches_repro(cfg):
    for step in (0, 1, 2, 3, 4, 5, 10, 19, 20, 21, 99, 100, 101, 5000,
                 10_000, 12_345):
        want = float(jadamw.cosine_lr(_jcfg(cfg), jnp.asarray(step,
                                                              jnp.int32)))
        got = cosine_lr(cfg, step)
        assert abs(got - want) <= TOL * max(abs(want), 1e-12), (step, got,
                                                                 want)


def test_global_norm_matches_repro():
    rng = np.random.default_rng(0)
    shapes = [(3, 5), (7,), (2, 3, 4), ()]
    leaves = [rng.normal(size=s).astype(np.float32) * 10 ** i
              for i, s in enumerate(shapes)]
    tree = {"a": torch.tensor(leaves[0]),
            "blocks": [{"b": torch.tensor(leaves[1]).to(torch.bfloat16)},
                       {"b": torch.tensor(leaves[2])}],
            "c": torch.tensor(leaves[3])}
    jtree = {"a": leaves[0], "b1": jnp.asarray(leaves[1], jnp.bfloat16),
             "b2": leaves[2], "c": leaves[3]}
    got = global_norm(tree)
    assert got.dtype == torch.float32 and got.ndim == 0
    want = float(jadamw.global_norm(jtree))
    assert abs(float(got) - want) <= TOL * want


@pytest.fixture(scope="module")
def zamba():
    """zamba2-7b's smoke config and ``repro``'s init as numpy (a hybrid:
    stacked Mamba2 layers with rank-1 norm scales, dt_bias, A_log, D and
    conv biases, and the unstacked shared attention block), made once for
    the module; each test bridges its own copy of the port's params."""
    jc, tc = jresolve("zamba2-7b", smoke=True), resolve("zamba2-7b",
                                                        smoke=True)
    return tc, jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))


def test_weight_decay_follows_repros_stacked_ranks(zamba):
    """With zero gradients the update is the decay alone: ``repro`` decays
    a leaf of rank >= 2 in its stacked layout, so every per-layer leaf
    (a Mamba2 layer's norm scale, dt_bias, A_log, D, conv biases
    included) and not ``final_norm`` or the shared block's norm scales.
    The port, whose layers are a list, decays the same leaves by the
    same amount."""
    tc, tree = zamba
    tree = jax.tree.map(lambda a: a + 1.0, tree)    # no zero leaf
    params = params_from_repro(tree, tc, device="cpu")
    cfg = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=10)
    grads = _tree.tree_map(torch.zeros_like, params)
    before = params_to_repro(params, tc)
    params, _ = adamw_update(cfg, grads, adamw_init(params), params)
    after = params_to_repro(params, tc)
    jgrads = jax.tree.map(jnp.zeros_like, tree)
    want, _ = _jupdate(_jcfg(cfg), jgrads, jadamw.adamw_init(tree), tree)
    moved = {}
    for path, got in _tree.flatten(after):
        w = want
        for k in path:
            w = w[k]
        _close(got, np.asarray(w, np.float32))
        b = before
        for k in path:
            b = b[k]
        moved["/".join(path)] = not np.array_equal(got, b)
    for name in ("blocks/ln1/scale", "blocks/mamba/dt_bias",
                 "blocks/mamba/A_log", "blocks/mamba/D",
                 "blocks/mamba/conv_x_b", "blocks/mamba/norm/scale",
                 "blocks/mamba/w_x", "shared_attn/attn/wq", "embed/tok"):
        assert moved[name], name
    for name in ("final_norm/scale", "shared_attn/ln1/scale",
                 "shared_attn/ln2/scale"):
        assert not moved[name], name


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_repro(zamba, steps):
    """Random gradients on zamba2-7b's smoke tree, large enough that the
    clip engages: params, m, v and count after each step."""
    tc, tree = zamba
    params = params_from_repro(tree, tc, device="cpu")
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    state, jstate, jparams = adamw_init(params), jadamw.adamw_init(tree), \
        tree
    rng = np.random.default_rng(5)
    for _ in range(steps):
        jgrads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        grads = params_from_repro(jgrads, tc, device="cpu")
        grads = _tree.tree_map(lambda g, p: g.float(), grads, params)
        params, state = adamw_update(cfg, grads, state, params)
        jparams, jstate = _jupdate(_jcfg(cfg), jgrads, jstate, jparams)
    assert state["count"] == int(jstate["count"]) == steps
    for mine, theirs in ((params, jparams), (state["m"], jstate["m"]),
                         (state["v"], jstate["v"])):
        got = dict(_tree.flatten(params_to_repro(mine, tc)))
        want = dict(_tree.flatten(jax.tree.map(
            lambda a: np.asarray(a, np.float32), theirs)))
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k])


def test_adamw_keeps_dtypes_and_updates_in_place():
    p = {"w": torch.ones((4, 3), dtype=torch.bfloat16),
         "blocks": [{"s": torch.ones(3, dtype=torch.bfloat16)}]}
    g = _tree.tree_map(lambda t: torch.full(t.shape, 0.5), p)
    state = adamw_init(p)
    ids = [id(t) for t in _tree.leaves(p)]
    out, state2 = adamw_update(AdamWConfig(lr=0.1, warmup_steps=0),
                               g, state, p)
    assert out is p and state2 is state and state["count"] == 1
    assert [id(t) for t in _tree.leaves(out)] == ids
    assert all(t.dtype == torch.bfloat16 for t in _tree.leaves(out))
    assert all(t.dtype == torch.float32 for t in _tree.leaves(state["m"]))
    assert float(p["w"].float().max()) < 1.0
