"""The port's training checkpoints across ranks, against ``repro``'s.

One 4-rank gloo world (``--pods 2``, ``repro_torch.launch.mesh.spawn``)
trains llama3.2-3b ``--smoke`` (f32) from ``repro``'s seed-0 weights
with ``--ckpt`` (``_torch_dist_workers.train_ckpt_rank``):

  * ``--gradsync`` native, lane_zero1 and lane_zero3, 2 steps: the
    checkpoint at step 2 has ``repro``'s driver checkpoint's manifest
    (step, layout, every leaf's shape and dtype) and its values leaf for
    leaf, within the rounding the two packages' steps differ by
    (``repro`` in a subprocess on 4 host devices, the same flags);
  * the lane_zero3 checkpoint restored at p = 2 as lane_zero1, that at
    p = 1 as the replicated layout, and that at p = 4 as lane_zero3 and
    lane_zero1 again, each written anew: every checkpoint of the chain
    holds the same canonical values bit for bit, and the zero3 one at p
    = 4 the same files as the original;
  * a resumed run (lane_zero3, step 4 removed) gives the uninterrupted
    run's losses at steps 3 and 4 exactly, and resuming at completion
    trains nothing and writes nothing.

In spawned processes (a SIGTERM handler is process-global): SIGTERM at
step 2 commits step 3 and restores the old handler, also when only one
rank of two gets it; a crash at step 2 commits step 2 and re-raises; a
failing writer on the SIGTERM path is reported and raised.
"""
import filecmp
import json
import pathlib
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

ARCH = "llama3.2-3b"
BASE = ["--smoke", "--batch", "4", "--seq", "32", "--pods", "2",
        "--log-every", "1"]
STRATEGIES = ("native", "lane_zero1", "lane_zero3")
KIND = {"native": "replicated", "lane_zero1": "zero1", "lane_zero3": "zero3"}
# the two packages' steps agree within float rounding (losses within
# 1e-6, tests/test_torch_train_zero.py); after two steps the parameters
# and the moments, AdamW's normalised step included, stay this close
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-9)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ckpt")
    jdir = tmp / "repro"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "ckpt", str(jdir),
         ",".join(STRATEGIES), "--arch", ARCH, *BASE, "--steps", "2",
         "--ckpt-every", "2"],
        env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        npz = tmp / "weights.npz"
        save_tree(npz, jax.tree.map(np.asarray, jinit(
            jax.random.PRNGKey(0), jresolve(ARCH, smoke=True))))
        port = tmp / "port"
        ranks = mesh.spawn(workers.train_ckpt_rank, 4, str(port), ARCH,
                           str(npz), BASE)
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    return jdir, port, ranks


def _manifest(d):
    return json.loads((pathlib.Path(d) / "manifest.json").read_text())


@pytest.mark.parametrize("gradsync", STRATEGIES)
def test_checkpoint_matches_repros_driver(world, gradsync):
    jdir, port, ranks = world
    want_d, got_d = jdir / gradsync / "step_2", port / gradsync / "step_2"
    jm, tm = _manifest(want_d), _manifest(got_d)
    assert tm["step"] == jm["step"] == 2
    assert tm["layout"] == jm["layout"]
    assert tm["layout"]["kind"] == KIND[gradsync]
    assert [(e["shape"], e["dtype"]) for e in tm["leaves"]] == \
        [(e["shape"], e["dtype"]) for e in jm["leaves"]]
    assert len({tuple(r[gradsync]) for r in ranks}) == 1
    n_params = len(_manifest(port / "native" / "step_2")["leaves"]) // 3
    for i, e in enumerate(jm["leaves"]):
        a = np.load(got_d / f"arr_{i}.npy")
        b = np.load(want_d / f"arr_{i}.npy")
        if e["shape"] == []:                      # the step counts
            assert a == b == 2, i
        elif gradsync != "lane_zero3" and i < n_params \
                or gradsync == "lane_zero3" and i < 2:
            np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, **MOMENT_TOL, err_msg=str(i))


@pytest.mark.parametrize("name", ["chain_zero1_p2", "chain_replicated_p1",
                                  "chain_zero3_p4", "chain_zero1_p4"])
def test_cross_layout_restores_are_bit_identical(world, name):
    _, port, _ = world
    want = workers.canonical_digest(str(port / "lane_zero3"), ARCH)
    assert workers.canonical_digest(str(port / name), ARCH) == want
    kind = {"zero1": "zero1", "replicated": "replicated",
            "zero3": "zero3"}[name.split("_")[1]]
    assert _manifest(port / name / "step_2")["layout"]["kind"] == kind


def test_zero3_round_trip_gives_the_same_files(world):
    _, port, _ = world
    a, b = port / "lane_zero3" / "step_2", port / "chain_zero3_p4" / "step_2"
    man = _manifest(a)
    assert _manifest(b)["leaves"] == man["leaves"]
    for i in range(len(man["leaves"])):
        assert filecmp.cmp(a / f"arr_{i}.npy", b / f"arr_{i}.npy",
                           shallow=False), i


def test_resumed_run_gives_the_uninterrupted_losses(world):
    _, _, ranks = world
    for r in ranks:
        assert len(r["uninterrupted"]) == 4 and all(
            np.isfinite(r["uninterrupted"]))
        assert r["resumed"] == r["uninterrupted"][2:]
    # the first two steps are the 2-step lane_zero3 run's
    np.testing.assert_array_equal(ranks[0]["uninterrupted"][:1],
                                  ranks[0]["lane_zero3"][:1])


def test_resume_at_completion_is_a_noop(world):
    _, _, ranks = world
    for r in ranks:
        assert r["completed"] == []
        assert r["resume_steps"] == [2, 4]


# ---------------------------------------------------------------------------
# emergency checkpoints, each in a spawned process
# ---------------------------------------------------------------------------

ONE = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
       "--steps", "6", "--device", "cpu"]


def test_sigterm_emergency_checkpoint(tmp_path):
    err, steps_, restored, losses, out, _ = mesh.spawn(
        workers.emergency_rank, 1, str(tmp_path / "ck"), "sigterm", ONE)[0]
    assert err is None and restored
    assert "SIGTERM: emergency checkpoint" in out
    assert steps_ == [3]                  # step 2 completed, then stopped
    assert len(losses) == 3


def test_sigterm_on_one_rank_stops_every_rank(tmp_path):
    """On a 2-rank world only rank 1 gets SIGTERM: the flag is reduced
    over the ranks, so both stop after step 2 and step 3 is committed."""
    ranks = mesh.spawn(workers.emergency_rank, 2, str(tmp_path / "ck"),
                       "sigterm", ONE)
    for err, steps_, restored, losses, _, _ in ranks:
        assert err is None and restored
        assert steps_ == [3] and len(losses) == 3
    assert "SIGTERM: emergency checkpoint" in ranks[0][4]


def test_crash_saves_last_completed_step(tmp_path):
    err, steps_, restored, _, _, _ = mesh.spawn(
        workers.emergency_rank, 1, str(tmp_path / "ck"), "crash", ONE)[0]
    assert "injected data failure" in err and restored
    assert steps_ == [2]                  # steps 0 and 1 completed


def test_sigterm_emergency_surfaces_writer_error(tmp_path):
    err, steps_, restored, _, _, log = mesh.spawn(
        workers.emergency_rank, 1, str(tmp_path / "ck"), "writer", ONE)[0]
    assert err is not None and "disk full" in err and restored
    assert "CHECKPOINT ERROR" in log
    assert steps_ == []
