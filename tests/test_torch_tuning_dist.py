"""The port's measured-cost tuning across ranks, against ``repro``'s.

One 4-rank gloo world of 2 pods x 2 (``repro_torch.launch.mesh.spawn``,
``_torch_dist_workers.tuning_rank``) probes the collectives and trains
llama3.2-3b ``--smoke`` for 3 steps under ``--gradsync auto``, beside one
``repro`` subprocess with 4 host devices (``_repro_lane_side.py
tuning``).  Held to:

  * every rank's probed table is identical (the probe takes each
    repetition's slowest rank), and its cells are ``repro``'s
    ``probe_cells``' on a 2 x 2 mesh (the timings themselves are not
    compared: they are measurements);
  * on a planted cache, the port's training loop selects ``repro``'s
    strategy from the same source, and its losses are ``repro``'s within
    the lane tests' tolerance (``test_torch_train_lane.py``);
  * the tuner changes only which strategy runs: ``--gradsync <the
    strategy auto chose>`` gives the same losses and parameters, bit for
    bit;
  * the cache is the lead's: with no file on the other ranks they
    dispatch on the lead's table all the same;
  * ``--tune`` commits one cache that every rank reads back whole, and
    the constants a cache installs are its topology's fit, gone when
    ``run`` returns.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.tuning import (TimingEntry as JEntry, TimingTable as JTable,
                          save_timing_table as jsave,
                          topology_signature as jsig)
from repro_torch import _tree
from repro_torch.configs import resolve
from repro_torch.launch import mesh
from repro_torch.models import init_model
from repro_torch.tuning import TimingEntry, TimingTable, fit_hw

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env, save_tree

ARCH = "llama3.2-3b"
FLAGS = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4",
         "--seq", "32", "--pods", "2"]
REPRO_TOL = 1e-5            # test_torch_train_lane.py's
# the planted cache: measured medians (µs) at the step's gradient payload
# on the 2 x 2 topology, ranking lane first
PLANTED = {"native": 300.0, "lane": 100.0, "lane_pipelined": 200.0}


def _grad_payload() -> int:
    params = init_model(resolve(ARCH, smoke=True), device="cpu")
    return sum(l.numel() for l in _tree.leaves(params)) * 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tuning_dist")
    payload = _grad_payload()
    sig = jsig(2, 2, platform="cpu", device_kind="cpu")
    planted = JTable([JEntry("grad_sync", s, sig, payload, us, us, 3)
                      for s, us in PLANTED.items()])
    for side in ("port", "repro"):
        jsave(tmp / f"planted_{side}.json", planted)
    out = tmp / "repro.json"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "tuning", str(out),
         str(tmp / "planted_repro.json"), *FLAGS, "--gradsync", "auto"],
        env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        npz = tmp / f"{ARCH}.npz"
        save_tree(npz, jax.tree.map(np.asarray, jinit(
            jax.random.PRNGKey(0), jresolve(ARCH, smoke=True))))
        ranks = mesh.spawn(workers.tuning_rank, 4, str(npz),
                           str(tmp / "planted_port.json"),
                           str(tmp / "tuned.json"),
                           FLAGS + ["--device", "cpu"])
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    return ranks, json.loads(out.read_text()), payload


def test_probed_tables_identical_across_ranks(runs):
    ranks, _, _ = runs
    docs = [r["probe"] for r in ranks]
    assert docs[0] and all(d == docs[0] for d in docs)


def test_probed_cells_are_repros(runs):
    ranks, want, _ = runs
    got = [[e.collective, e.strategy, e.topo_sig, e.bucket]
           for e in TimingTable.from_doc(ranks[0]["probe"]).entries()]
    assert got == want["keys"]


def test_auto_on_planted_cache_selects_as_repro(runs):
    ranks, want, payload = runs
    assert want["selections"] == [["lane", "measured", payload]]
    for r in ranks:
        _, sels, _ = r["auto"]
        assert len(sels) == 3       # one sync a step
        assert {tuple(s) for s in sels} == {("lane", "measured", payload)}


def test_auto_losses_match_repro(runs):
    ranks, want, _ = runs
    assert len(want["losses"]) == 3
    for r in ranks:
        np.testing.assert_allclose(r["auto"][0], want["losses"],
                                   rtol=REPRO_TOL)


def test_tuner_changes_only_the_strategy(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["fixed"][0] == r["auto"][0]
        assert r["fixed"][2] == r["auto"][2]
        assert r["fixed"][1] == []          # no auto dispatch
    assert len({r["auto"][2] for r in ranks}) == 1


def test_only_the_lead_reads_the_cache(runs):
    ranks, _, payload = runs
    for r in ranks:
        assert r["lead_only"] == r["auto"]
        assert {tuple(s) for s in r["lead_only"][1]} == \
            {("lane", "measured", payload)}


def test_tune_commits_one_cache_every_rank_reads(runs):
    ranks, _, _ = runs
    docs = [r["tuned_cache"] for r in ranks]
    assert docs[0] and all(d == docs[0] for d in docs)
    sigs = {row["topo_sig"] for row in docs[0]}
    assert sigs == {"cpu/cpu/n2xN2"}
    for r in ranks:
        losses, sels, _ = r["tuned"]
        assert len(losses) == 3 and sels
        assert sels == ranks[0]["tuned"][1]
    assert len({r["tuned"][2] for r in ranks}) == 1


def test_run_restores_the_constants(runs):
    ranks, _, payload = runs
    planted = TimingTable([TimingEntry("grad_sync", s, "cpu/cpu/n2xN2",
                                       payload, us, us, 3)
                           for s, us in PLANTED.items()])
    for r in ranks:
        before, after = r["hw"]
        assert after == before
        assert r["priced"] != before
        assert r["priced"] == fit_hw(planted, topo_sig="cpu/cpu/n2xN2").hw
