"""The port's ZeRO training across ranks against ``repro``'s, on the CPU.

A 4-rank gloo world (``repro_torch.launch.mesh.spawn``) runs
``repro_torch.launch.train`` for 3 steps with ``--gradsync lane_zero1
--pods 2`` and ``--gradsync lane_zero3 --pods 2`` (with the default
prefetch, ``--fsdp-prefetch -1`` and ``--fsdp-regather``) on llama3.2-3b,
granite-moe-3b-a800m, mamba2-780m and zamba2-7b ``--smoke``, from
``repro.models.init_model``'s weights.  Held to:

  * ``python -m repro.launch.train`` with the same flags on 4 host
    devices (``_repro_lane_side.py``, one subprocess per strategy): every
    loss of every rank within 1e-6, relative; the three ``lane_zero3``
    modes all within that of ``repro``'s and of each other;
  * the whole parameter tree after the last step (gathered from the
    stripes under ``lane_zero3``) is bitwise equal on every rank.

These configs are f32.  In bf16 (mixed precision: f32 master stripes,
bf16 rows gathered), ``lane_zero3`` on a one-rank world follows the
witness of ``chip_smoke.py``'s phase 9b, "masters": the replicated
step's bf16 forward and backward with the per-leaf AdamW on f32 master
copies, which shares no ZeRO code, within 1e-6 at every step, AdamW
unclipped as in 9b (the replicated bf16 step itself drops the updates
below half an ulp that the masters keep, so it is no reference past
step 2).
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro_torch.launch import mesh

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env, save_tree

ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "mamba2-780m", "zamba2-7b"]
BASE = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
        "--pods", "2"]
STRATEGIES = ("lane_zero1", "lane_zero3")
MODES = {"lane_zero1": ["--gradsync", "lane_zero1"],
         "lane_zero3": ["--gradsync", "lane_zero3"],
         "blocking": ["--gradsync", "lane_zero3", "--fsdp-prefetch", "-1"],
         "regather": ["--gradsync", "lane_zero3", "--fsdp-regather"]}
TOL = 1e-6
WITNESS_ARCHS = ["llama3.2-3b", "mamba2-780m"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's losses {strategy: {arch: [...]}}, the port's
    {mode: {arch: [(losses, digest, params) by rank]}})."""
    tmp = tmp_path_factory.mktemp("train_zero")
    procs = {}
    for strategy in STRATEGIES:
        procs[strategy] = subprocess.Popen(
            [sys.executable, str(REPRO_SIDE), "train",
             str(tmp / f"{strategy}.json"),
             *[a for arch in ARCHS for a in ("--arch", arch)], *BASE,
             "--gradsync", strategy],
            env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    try:
        work = []
        for arch in ARCHS:
            path = tmp / f"{arch}.npz"
            save_tree(path, jax.tree.map(np.asarray, jinit(
                jax.random.PRNGKey(0), jresolve(arch, smoke=True))))
            work += [(["--arch", arch, *BASE, *flags, "--device", "cpu"],
                      str(path)) for flags in MODES.values()]
        ranks = mesh.spawn(workers.zero_train_rank, 4, work)
        logs = {s: p.communicate(timeout=600)[0] for s, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for s, p in procs.items():
        assert p.returncode == 0, logs[s][-4000:]
    want = {s: json.loads((tmp / f"{s}.json").read_text())
            for s in STRATEGIES}
    port, k = {}, 0
    for arch in ARCHS:
        for mode in MODES:
            port.setdefault(mode, {})[arch] = [r[k] for r in ranks]
            k += 1
    return want, port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zero_train_matches_repro(runs, strategy, arch):
    want, port = runs
    w = want[strategy][arch]
    assert len(w) == 3 and all(np.isfinite(w))
    for losses, _, _ in port[strategy][arch]:
        np.testing.assert_allclose(losses, w, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["blocking", "regather"])
def test_zero3_modes_give_the_same_losses(runs, mode, arch):
    want, port = runs
    prefetch = port["lane_zero3"][arch][0][0]
    for losses, _, _ in port[mode][arch]:
        np.testing.assert_allclose(losses, want["lane_zero3"][arch],
                                   rtol=TOL)
        np.testing.assert_allclose(losses, prefetch, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_train_params_equal_across_ranks(runs, arch):
    _, port = runs
    for mode in MODES:
        digests = {d for _, d, _ in port[mode][arch]}
        assert len(digests) == 1, (mode, digests)
    # ZeRO-1 and ZeRO-3 apply the same AdamW: their parameters agree to
    # the rounding of the norms' sums
    z1, z3 = port["lane_zero1"][arch][0][2], port["lane_zero3"][arch][0][2]
    for a, b in zip(jax.tree.leaves(z1), jax.tree.leaves(z3)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def witness_runs():
    return mesh.spawn(workers.zero_witness_rank, 1, WITNESS_ARCHS)[0]


@pytest.mark.parametrize("arch", WITNESS_ARCHS)
def test_zero3_bf16_follows_f32_masters(witness_runs, arch):
    rep, masters, zero3 = (witness_runs[arch, m] for m in
                           ("replicated", "masters", "lane_zero3"))
    assert all(np.isfinite(zero3))
    # the same bf16 weights through the same forward
    assert zero3[0] == masters[0] == rep[0]
    np.testing.assert_allclose(zero3, masters, rtol=TOL)
