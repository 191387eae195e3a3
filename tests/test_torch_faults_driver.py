"""The port's recovery ladder across ranks against ``repro``'s, on the CPU.

A 4-rank gloo world (2 pods x 2, ``repro_torch.launch.mesh.spawn``)
holds the quorum collectives of ``runtime.straggler`` and the
``lane_quorum`` grad sync to ``repro``'s on a (pod 2 x data 2) mesh of 4
host devices (``_repro_lane_side.py quorum``) under every mask of the
two pods, within 1e-6 in f32, and to the port's own ``lane`` bit for bit
under the full quorum.  A second 4-rank world runs the training loop
(``_torch_dist_workers.faults_rank``), llama3.2-3b ``--smoke``, batch 8,
seq 32, as ``repro``'s ``driver_cases`` run it:

  * the ladder (``fault_ladder_degraded_restart_bitident``):
    ``--gradsync lane_quorum --pods 2 --fault-plan pod_lost@2:pod=1
    --quorum-staleness 2 --steps 8 --seed 7``: ``repro``'s transitions
    and replay line, every loss within 1e-6 of ``repro``'s training loop
    (``_repro_lane_side.py faults``, the same flags and weights), and
    step 8's files byte-identical to a fresh launch with ``--lose-chips
    2,3`` resumed from the same emergency checkpoint;
  * masked equals skipped (``fault_quorum_masked_equals_skipped_
    microbatch``): pod 1 masked for the whole run gives the parameters
    and the checkpoint, bit for bit, of a ``lane`` run whose pod-1 rows
    repeat pod 0's;
  * losing pod 0 (world ranks 0 and 1): ranks 2 and 3 train, rank 2
    writes the checkpoint, the losses within 1e-6 of ``repro``'s;
  * the cascade: ``pod_lost@2:pod=0`` renumbers onto the survivor and
    fires again; ``repro``'s transitions, then ``repro``'s ValueError.

The checkpoint rungs run on one process in the test process, as
``repro``'s cases run them: a corrupt latest falls back, transient I/O
is retried, and a kill mid-write restores the prior commit.
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
from repro_torch.checkpoint import (CheckpointCorruptError, committed_steps,
                                    latest_step, latest_verified_step,
                                    verify_checkpoint)
from repro_torch.launch import mesh, train

import _collective_grid as grid
import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env, save_tree

ARCH = "llama3.2-3b"
TOL = 1e-6
BASE = ["--arch", ARCH, "--smoke", "--batch", "8", "--seq", "32",
        "--log-every", "1", "--device", "cpu"]
LADDER = ["--gradsync", "lane_quorum", "--pods", "2", "--ckpt", "{ckpt}",
          "--ckpt-every", "100", "--steps", "8", "--seed", "7"]
# (name, argv after BASE, mode): see _torch_dist_workers.faults_rank
CASES = [
    ("ladder", [*LADDER, "--fault-plan", "pod_lost@2:pod=1",
                "--quorum-staleness", "2"], "repro_weights"),
    ("fresh", [*LADDER, "--lose-chips", "2,3"], "copy=ladder/8"),
    ("masked", ["--pods", "2", "--ckpt", "{ckpt}", "--ckpt-every", "2",
                "--steps", "2", "--seed", "7", "--gradsync", "lane_quorum",
                "--fault-plan", "pod_slow@0-1:pod=1",
                "--quorum-staleness", "99"], "repro_weights"),
    ("skipped", ["--pods", "2", "--ckpt", "{ckpt}", "--ckpt-every", "2",
                 "--steps", "2", "--seed", "7", "--gradsync", "lane"],
     "repro_weights+dup_pod0"),
    ("lose0", ["--gradsync", "lane", "--pods", "2", "--lose-chips", "0,1",
               "--steps", "3", "--seed", "7", "--ckpt", "{ckpt}",
               "--ckpt-every", "100"], "repro_weights"),
    ("cascade", [*LADDER, "--fault-plan", "pod_lost@2:pod=0",
                 "--quorum-staleness", "2"], "repro_weights"),
]
REPRO_CASES = ("ladder", "lose0", "cascade")


def _transitions(log):
    """(step, old, new) of every ``health:`` line of a log."""
    out = []
    for line in log.splitlines():
        if line.startswith("health: step "):
            head, _, rest = line[len("health: step "):].partition(": ")
            old, _, new = rest.split(" (")[0].partition(" -> ")
            out.append((int(head), old, new))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    cases = {name: [a.format(ckpt=str(tmp / "repro" / name)) for a in
                    [*BASE[:-2], *argv]]
             for name, argv, _ in CASES if name in REPRO_CASES}
    (tmp / "cases.json").write_text(json.dumps(cases))
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "faults", str(tmp / "cases.json"),
         str(tmp / "repro.json")],
        env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        npz = tmp / "weights.npz"
        save_tree(npz, jax.tree.map(np.asarray, jinit(
            jax.random.PRNGKey(7), jresolve(ARCH, smoke=True))))
        ranks = mesh.spawn(workers.faults_rank, 4, str(tmp / "port"),
                           str(npz), BASE, CASES)
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    return tmp / "port", ranks, json.loads((tmp / "repro.json").read_text())


@pytest.fixture(scope="module")
def quorum(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quorum")
    rng = np.random.default_rng(21)
    data = {"x": rng.normal(size=(4, 37)).astype(np.float32),
            "loss": rng.normal(size=(4,)).astype(np.float32),
            "tree/a": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "tree/b": rng.normal(size=(4, 17)).astype(np.float32)}
    np.savez(tmp / "in.npz", **data)
    proc = subprocess.run(
        [sys.executable, str(REPRO_SIDE), "quorum", str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=repro_env(4), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    ranks = mesh.spawn(workers.quorum_rank, 4, str(tmp / "in.npz"))
    with np.load(tmp / "out.npz") as z:
        want = {k: z[k] for k in z.files}
    return ranks, want


# ---------------------------------------------------------------------------
# the quorum collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", grid.QUORUM_MASKS,
                         ids=lambda m: "".join(map(str, m)))
def test_quorum_collectives_match_repro(quorum, mask):
    ranks, want = quorum
    key = "".join(map(str, mask))
    for g, got in enumerate(ranks):
        for name in ("stage", "mean", "tree/a", "tree/b"):
            np.testing.assert_allclose(got[f"{key}/{name}"],
                                       want[f"{key}/{name}"][g],
                                       rtol=0, atol=TOL, err_msg=name)
    if mask == (0, 0):              # nobody contributes: exactly zero
        for got in ranks:
            assert not np.any(got["00/tree/a"]) and got["00/mean"] == 0


def test_full_quorum_is_bit_identical_to_lane(quorum):
    ranks, _ = quorum
    for got in ranks:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(got[f"11/tree/{leaf}"],
                                          got[f"lane/tree/{leaf}"])


# ---------------------------------------------------------------------------
# the recovery ladder
# ---------------------------------------------------------------------------

def test_ladder_degrades_then_restarts_as_repro(world):
    _, ranks, want = world
    out = ranks[0]["ladder"]["out"]
    assert "HEALTHY -> DEGRADED" in out and "DEGRADED -> RESTART" in out
    assert "replayable from (seed=7, step=2)" in out
    assert "degraded step 2: pod 1 masked; rows [4, 8) dropped" in out
    assert "RESTART at step 4" in out and "resumed from step 4" in out
    assert _transitions(out) == _transitions(want["ladder"]["log"])
    for r in ranks:                 # every rank kept the same events
        assert r["ladder"]["events"] == ranks[0]["ladder"]["events"]
        assert r["ladder"]["restarts"] == 1
    assert not ranks[2]["ladder"]["out"]   # only the lead prints


def test_ladder_losses_match_repro(world):
    _, ranks, want = world
    ref = want["ladder"]["losses"]
    assert len(ref) == 8 and want["ladder"]["rc"] == 0
    np.testing.assert_allclose(ranks[0]["ladder"]["losses"], ref, rtol=TOL)
    # the lost pod's ranks leave with the steps they took
    assert ranks[2]["ladder"]["losses"] == ranks[0]["ladder"]["losses"][:4]
    assert ranks[2]["ladder"]["digest"] is None
    assert ranks[0]["ladder"]["digest"] == ranks[1]["ladder"]["digest"]


def test_ladder_restart_equals_fresh_launch_byte_for_byte(world):
    port, ranks, _ = world
    assert committed_steps(port / "ladder") == [4, 8]
    a, b = port / "ladder" / "step_8", port / "fresh" / "step_8"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    assert ranks[0]["fresh"]["losses"] == ranks[0]["ladder"]["losses"][4:]
    assert ranks[3]["fresh"]["losses"] == []


def test_masked_pod_equals_skipped_rows(world):
    port, ranks, _ = world
    assert "pod 1 masked; rows [4, 8) dropped" in ranks[0]["masked"]["out"]
    masked, skipped = ranks[0]["masked"], ranks[0]["skipped"]
    assert all(x > 1 for x in masked["losses"])      # gradients that move
    np.testing.assert_allclose(masked["losses"], skipped["losses"],
                               rtol=TOL)
    assert len({r[name]["digest"] for r in ranks
                for name in ("masked", "skipped")}) == 1
    a, b = port / "masked" / "step_2", port / "skipped" / "step_2"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        if name.startswith("arr_"):
            assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_losing_pod_0_trains_on_ranks_2_and_3(world):
    port, ranks, want = world
    for g in (0, 1):
        assert ranks[g]["lose0"]["losses"] == []
        assert ranks[g]["lose0"]["saves"] == [] and not \
            ranks[g]["lose0"]["out"]
    assert ranks[2]["lose0"]["saves"] == [3] and ranks[3]["lose0"]["saves"] \
        == []
    assert "elastic mesh: {'pod': 1, 'data': 2, 'model': 1} (lost (0, 1))" \
        in ranks[2]["lose0"]["out"]
    assert ranks[2]["lose0"]["digest"] == ranks[3]["lose0"]["digest"]
    assert latest_step(port / "lose0") == 3
    np.testing.assert_allclose(ranks[2]["lose0"]["losses"],
                               want["lose0"]["losses"], rtol=TOL)


def test_cascade_raises_repros_error(world):
    _, ranks, want = world
    ref = want["cascade"]
    assert ref["error"] == "all slices of the outer batch axis lost"
    for g in (2, 3):
        assert ranks[g]["cascade"]["error"] == ref["error"]
    for g in (0, 1):                # left at the first restart
        assert ranks[g]["cascade"]["error"] is None
        assert ranks[g]["cascade"]["digest"] is None
    got = ranks[2]["cascade"]["events"]
    assert got == _transitions(ref["log"])
    assert [e[2] for e in got] == ["DEGRADED", "RESTART", "DEGRADED",
                                   "RESTART"]
    # the steps of the first attempt, which every rank took
    np.testing.assert_allclose(ranks[0]["cascade"]["losses"],
                               ref["losses"][:4], rtol=TOL)


# ---------------------------------------------------------------------------
# the checkpoint rungs, on one process
# ---------------------------------------------------------------------------

ONE = ["--arch", ARCH, "--smoke", "--batch", "8", "--seq", "32",
       "--log-every", "1", "--gradsync", "lane", "--device", "cpu"]


def test_fault_corrupt_latest_falls_back(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = [*ONE, "--ckpt", ck, "--ckpt-every", "2"]
    train.main([*base, "--steps", "4", "--fault-plan",
                "corrupt_leaf@4:leaf=1"])
    assert "fault: corrupted" in capsys.readouterr().out
    assert latest_step(ck) == 4
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(ck, 4)
    assert latest_verified_step(ck) == 2
    train.main([*base, "--steps", "6"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert latest_step(ck) == 6
    verify_checkpoint(ck, 6)


def test_fault_ckpt_io_transient_retry(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train.main([*ONE, "--ckpt", ck, "--ckpt-every", "2", "--steps", "2",
                "--fault-plan", "ckpt_io@2:count=2"])
    err = capsys.readouterr().err
    assert "attempt 1/3 failed" in err and "attempt 2/3 failed" in err
    assert latest_step(ck) == 2
    verify_checkpoint(ck, 2)


def test_fault_kill_mid_write_restores_prior_commit(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = [*ONE, "--ckpt", ck, "--ckpt-every", "2"]
    train.main([*base, "--steps", "2"])
    d = pathlib.Path(ck)
    (d / "step_2").rename(d / "step_2.old")        # parked, not yet
    (d / "step_2.tmp").mkdir()                     # ...renamed in
    (d / "step_2.tmp" / "arr_0.npy").write_bytes(b"partial")
    (d / "step_backup").mkdir()                    # a stray directory
    assert committed_steps(ck) == [2]
    capsys.readouterr()
    train.main([*base, "--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert latest_step(ck) == 3
    assert (d / "step_3" / "manifest.json").exists()
