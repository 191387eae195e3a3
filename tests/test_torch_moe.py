"""The port's MoE layer against ``repro``'s, at smoke size in f32.

granite-moe-3b-a800m (10 experts, top 3) and dbrx-132b (8 experts, top 2)
smoke configs.  Both packages start from ``repro``'s layer-0 MoE weights,
and inputs are numpy draws.  The routing must agree exactly (experts,
slots, kept assignments); outputs and the aux loss within 1e-5 of the
reference's largest magnitude (at least 1): only the frameworks' f32
reduction order differs.  Two cases pin the capacity semantics: a router
biased toward a few experts, whose assignments overflow and are dropped,
and a router with equal probabilities, where top-k must take the lower
expert indices as ``lax.top_k`` does.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.models import moe as jM
from repro_torch.configs import resolve
from repro_torch.models import moe as M

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]
TOL = 1e-5


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


def _layer(arch):
    """(repro cfg, port cfg, layer-0 MoE weights as numpy)."""
    jc, tc = jresolve(arch, smoke=True), resolve(arch, smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    moe = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["moe"])
    return jc, tc, moe


def _both(moe, x):
    return ({k: jnp.asarray(v) for k, v in moe.items()}, jnp.asarray(x),
            {k: torch.tensor(v) for k, v in moe.items()}, torch.tensor(x))


def _run(jc, tc, moe, x):
    """Both packages' dispatch and block on the same weights and input;
    asserts the routing is identical and the outputs close.  Returns the
    port's ``keep``."""
    jp, jx, tp, tx = _both(moe, x)
    jbuf, jslot, jkeep, jtop_p, jaux, jC = jM._dispatch_buffer(jp, jx, jc)
    buf, slot, keep, top_p, aux, C = M._dispatch_buffer(tp, tx, tc)
    assert C == jC
    assert slot.tolist() == np.asarray(jslot).tolist()
    assert keep.tolist() == np.asarray(jkeep).tolist()
    _close(buf, jbuf)
    _close(top_p, jtop_p)
    _close(aux, jaux)
    got, gaux = M.moe_block(tp, tx, tc)
    want, waux = jM.moe_block(jp, jx, jc)
    _close(got, want)
    _close(gaux, waux)
    return keep


@pytest.mark.parametrize("T", [1, 13, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_repro(arch, T):
    jc, tc, moe = _layer(arch)
    x = np.random.default_rng(T).normal(size=(2, T, tc.d_model))
    _run(jc, tc, moe, x.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_repro(arch):
    jc, tc, _ = _layer(arch)
    for T in (1, 7, 8, 32, 33, 100, 512, 1500):
        assert M._capacity(tc, T) == jM._capacity(jc, T), T


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_drops_past_capacity(arch):
    """A router biased toward the low expert indices, its logits distinct:
    those experts overflow their capacity, the overflow goes to the trash
    slot, and the port drops exactly the assignments repro drops."""
    jc, tc, moe = _layer(arch)
    E, d = tc.num_experts, tc.d_model
    moe = dict(moe)
    moe["router"] = moe["router"] + np.linspace(
        4.0, 0.0, E, dtype=np.float32)[None] / d
    x = np.random.default_rng(5).normal(size=(2, 48, d)).astype(np.float32)
    keep = _run(jc, tc, moe, x + 1.0)          # mean 1: the bias shows
    assert int((~keep).sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_ties_take_the_lower_expert(arch):
    """A zero router gives every expert the same probability: top-k takes
    experts 0..K-1 for every token, in both packages."""
    jc, tc, moe = _layer(arch)
    moe = dict(moe, router=np.zeros_like(moe["router"]))
    x = np.random.default_rng(6).normal(
        size=(2, 12, tc.d_model)).astype(np.float32)
    K = tc.experts_per_token
    _, top_e, _ = M._route({"router": torch.tensor(moe["router"])},
                           torch.tensor(x), tc)
    assert top_e.tolist() == [[list(range(K))] * 12] * 2
    _run(jc, tc, moe, x)


def test_capacity_factor_e_over_k_never_drops():
    """``moe_capacity_factor = E/K`` makes C >= T, so nothing can drop:
    the setting under which the cached and no-cache forwards compute the
    same function (used by the on-card logit check)."""
    tc = resolve("granite-moe-3b-a800m", smoke=True)
    E, K = tc.num_experts, tc.experts_per_token
    wide = dataclasses.replace(tc, moe_capacity_factor=E / K)
    for T in (1, 3, 31, 64, 200):
        assert M._capacity(wide, T) >= T
