"""The port's tensor- and expert-parallel blocks across ranks against
``repro``'s, on the CPU.

One 8-rank gloo world (``repro_torch.launch.mesh.spawn``, the cases in
turn: ``_torch_dist_workers.parallel_rank``) beside one ``repro``
subprocess on 8 host devices (``_repro_lane_side.py parallel``), the
same numpy inputs (``_collective_grid``) on both:

  * the ``moe_route`` cells (``native`` and ``lane``) on ``repro``'s
    conformance topologies t3, het, n1 and N1, f32 (and bf16 and int32 on
    t3), integer-valued: bit for bit; 12 rows on t2 (p = 8) raise
    ``ValueError``;
  * ``mlp_tp`` on 2 and 4 model ranks (llama3.2-3b smoke, f32): each
    rank's output and gradients (the weight gradients zero-padded column
    blocks) within ``TOL`` of ``repro``'s ``mlp_tp``, and the output, the
    input's gradient and the weight gradients summed over the model ranks
    within ``TOL`` of the port's plain ``mlp``; ``mlp_tp_reduce`` within
    ``TOL`` of ``repro``'s (its backward sums the cotangent over the
    model group, as ``repro``'s autodiff of its all-reduce does);
  * ``moe_block_ep`` at ``ep_blocks`` 1 and 2 on a (pod 2 x data 2)
    topology (dbrx-132b smoke, f32, E = 8): each rank's output, aux loss
    and gradients within ``TOL`` of ``repro``'s ``moe_block_ep``; against
    the port's ``moe_block`` on the same rows, the output, the aux loss
    and the input's and router's gradients per rank, and the experts'
    gradients summed over the ranks (each rank's are its own experts',
    over every rank's tokens) within ``TOL``; ``ep_blocks`` 2 equal to 1
    bit for bit (the weight gradients are taken over the whole capacity
    once, not per block and summed).

In the test process, at p = 1 (no world: the routes are the identity):
``moe_block_ep`` at ``ep_blocks`` 1, 2 and 4, in f32 and in bf16, equal
to the port's ``moe_block`` bit for bit, output and every gradient.

``TOL`` is relative to each array's largest magnitude: the two packages'
f32 matmuls and the blocks' column slices round differently in the last
bits, and nothing else differs.
"""
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import mesh

import _collective_grid as grid
import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env

TOL = 1e-5
WORLD = 8


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(repro's arrays, the port's per-rank dicts by world rank)."""
    out = tmp_path_factory.mktemp("parallel") / "repro.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "parallel", str(out)],
        env=repro_env(WORLD), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = mesh.spawn(workers.parallel_rank, WORLD)
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return want, ranks


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.2e} > {TOL}"


ROUTE_CASES = [(key, case["name"]) for key in grid.MOE_ROUTE_TOPOS
               for case in grid.moe_route_cases(key)]


@pytest.mark.parametrize("key,name", ROUTE_CASES,
                         ids=[f"{k}-{n}" for k, n in ROUTE_CASES])
def test_moe_route_bit_for_bit(results, key, name):
    want, ranks = results
    got = np.stack([r[f"route/{key}/{name}"] for r in ranks])
    np.testing.assert_array_equal(got, want[f"route/{key}/{name}"])


def test_moe_route_indivisible_raises(results):
    _, ranks = results
    assert {r["route_error/t2"] for r in ranks} == {"ValueError"}


@pytest.mark.parametrize("tp", grid.TP_DEGREES)
@pytest.mark.parametrize("fn", ["mlp_tp", "mlp_tp_reduce"])
def test_tp_mlp_matches_repro(results, fn, tp):
    want, ranks = results
    for w, r in enumerate(ranks):
        k = w % tp                              # the model rank
        for key in ("y", "dx", "dw_up", "dw_gate", "dw_down"):
            _close(r[f"tp{tp}/{fn}/{key}"], want[f"tp{tp}/{fn}/{key}"][k],
                   f"{fn} tp={tp} rank {w} {key}")


@pytest.mark.parametrize("tp", grid.TP_DEGREES)
def test_mlp_tp_equals_mlp(results, tp):
    """Forward and input gradient on every rank, and the zero-padded
    weight-gradient blocks summed over a model group, against ``mlp``."""
    _, ranks = results
    for w, r in enumerate(ranks):
        for key in ("y", "dx"):
            _close(r[f"tp{tp}/mlp_tp/{key}"], r[f"tp{tp}/mlp/{key}"],
                   f"tp={tp} rank {w} {key}")
    for g0 in range(0, WORLD, tp):
        group = ranks[g0:g0 + tp]
        for key in ("dw_up", "dw_gate", "dw_down"):
            blocks = [r[f"tp{tp}/mlp_tp/{key}"] for r in group]
            # disjoint column blocks: each element is nonzero on one rank
            assert (np.count_nonzero(np.stack(blocks), axis=0) <= 1).all()
            _close(sum(blocks), group[0][f"tp{tp}/mlp/{key}"],
                   f"tp={tp} group {g0} {key}")
        _close(group[0][f"tp{tp}/mlp_tp_reduce/y"], group[0][f"tp{tp}/mlp/y"],
               f"mlp_tp_reduce tp={tp} y")


EP_KEYS = ("y", "aux", "dx", "drouter", "dw_up", "dw_gate", "dw_down")


def _global(w):
    """The global rank of world rank w in the EP topology (2 replicas)."""
    return w // 2


@pytest.mark.parametrize("blocks", grid.EP_BLOCKS)
def test_moe_block_ep_matches_repro(results, blocks):
    want, ranks = results
    for w, r in enumerate(ranks):
        for key in EP_KEYS:
            _close(r[f"ep{blocks}/{key}"], want[f"ep{blocks}/{key}"][
                _global(w)], f"ep_blocks={blocks} rank {w} {key}")


@pytest.mark.parametrize("blocks", grid.EP_BLOCKS)
def test_moe_block_ep_equals_gathered(results, blocks):
    _, ranks = results
    for w, r in enumerate(ranks):
        for key in ("y", "aux", "dx", "drouter"):
            _close(r[f"ep{blocks}/{key}"], r[f"gather/{key}"],
                   f"ep_blocks={blocks} rank {w} {key}")
        if blocks > 1:
            for key in EP_KEYS:
                np.testing.assert_array_equal(
                    r[f"ep{blocks}/{key}"], r[f"ep1/{key}"],
                    f"ep_blocks={blocks} against 1, rank {w} {key}")
    replica = ranks[0::2]                       # one replica, by global rank
    E = replica[0]["gather/dw_up"].shape[0]
    for key in ("dw_up", "dw_gate", "dw_down"):
        ep = [r[f"ep{blocks}/{key}"] for r in replica]
        # a rank's expert gradients are its own experts' alone
        for g, a in enumerate(ep):
            own = np.zeros(E, bool)
            own[g * E // len(ep):(g + 1) * E // len(ep)] = True
            assert not a[~own].any(), (key, g)
        _close(sum(ep), sum(r[f"gather/{key}"] for r in replica),
               f"ep_blocks={blocks} {key} summed")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_ep_blocks_equal_gathered_bitwise(dtype):
    """At p = 1 every ``ep_blocks`` gives ``moe_block``'s output and
    gradients bit for bit: summing per-block bf16 weight gradients
    instead parts the bf16 training losses from step 2."""
    import dataclasses

    import torch

    from repro_torch.comm import LaneComm
    from repro_torch.configs import resolve
    from repro_torch.launch.steps import _local_topology
    from repro_torch.models import init_model
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(resolve("granite-moe-3b-a800m", smoke=True),
                              dtype=dtype)
    p = init_model(cfg, seed=0, device="cpu")["blocks"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model), dtype=np.float32)).to(getattr(torch, dtype))
    comm = LaneComm(_local_topology())

    def fwd_bwd(fn):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        h = x.detach().requires_grad_(True)
        y, aux = fn(q, h)
        loss = (y.float() ** 2).sum() + aux
        return [y.detach(), *torch.autograd.grad(loss, [h, *q.values()])]

    want = fwd_bwd(lambda q, h: M.moe_block(q, h, cfg))
    for blocks in (1, 2, 4):
        got = fwd_bwd(lambda q, h: M.moe_block_ep(q, h, cfg, comm=comm,
                                                  ep_blocks=blocks))
        for name, a, b in zip(["y", "dx", *p], got, want):
            assert torch.equal(a, b), (blocks, name)
