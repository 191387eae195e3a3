"""The port's training across ranks against ``repro``'s, on the CPU.

A 4-rank gloo world (``repro_torch.launch.mesh.spawn``) runs
``repro_torch.launch.train`` with ``--gradsync lane --pods 2
--gradsync-buckets 4`` for 3 steps of llama3.2-3b and mamba2-780m
``--smoke``, from ``repro.models.init_model``'s weights (handed to the
ranks as numpy through ``_torch_dist_workers.save_tree``).  Each rank
takes its rows of the global batch in ``repro``'s sharding order and the
step syncs the gradients through the node/lane collectives.  Held to:

  * ``python -m repro.launch.train`` with the same flags on 4 host
    devices (a subprocess, ``_repro_lane_side.py``): the losses within
    1e-5 relative, the frameworks' f32 reduction orders differing;
  * the port's one-process run on the same global batch: within 1e-6
    (only the order of the gradient sums differs);
  * the parameters after the last step are bitwise equal on every rank.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.launch import mesh, train

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env, save_tree

ARCHS = ["llama3.2-3b", "mamba2-780m"]
FLAGS = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
         "--gradsync", "lane", "--pods", "2", "--gradsync-buckets", "4"]
REPRO_TOL = 1e-5
ONE_PROCESS_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: (repro's losses, [(losses, digest) by rank], one-process
    losses)}."""
    tmp = tmp_path_factory.mktemp("train_lane")
    out = tmp / "repro.json"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "train", str(out),
         *[a for arch in ARCHS for a in ("--arch", arch)], *FLAGS],
        env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        trees, work = {}, []
        for arch in ARCHS:
            trees[arch] = jax.tree.map(np.asarray, jinit(
                jax.random.PRNGKey(0), jresolve(arch, smoke=True)))
            path = tmp / f"{arch}.npz"
            save_tree(path, trees[arch])
            work.append((["--arch", arch, *FLAGS, "--device", "cpu"],
                         str(path)))
        ranks = mesh.spawn(workers.train_rank, 4, work)
        one = {}
        for arch in ARCHS:
            flags = [a for a in FLAGS if a not in ("--pods", "2")]
            one[arch] = train.run(
                ["--arch", arch, *flags, "--device", "cpu"],
                params=params_from_repro(trees[arch],
                                         resolve(arch, smoke=True),
                                         device="cpu"))[0]
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    want = json.loads(out.read_text())
    return {arch: (want[arch], [r[k] for r in ranks], one[arch])
            for k, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_lane_train_matches_repro(runs, arch):
    want, ranks, _ = runs[arch]
    assert len(want) == 3 and want[-1] < want[0]
    for losses, _ in ranks:
        np.testing.assert_allclose(losses, want, rtol=REPRO_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lane_train_matches_one_process(runs, arch):
    _, ranks, one = runs[arch]
    for losses, _ in ranks:
        np.testing.assert_allclose(losses, one, rtol=ONE_PROCESS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lane_train_params_bitwise_equal_across_ranks(runs, arch):
    _, ranks, _ = runs[arch]
    digests = {d for _, d in ranks}
    assert len(digests) == 1, digests
