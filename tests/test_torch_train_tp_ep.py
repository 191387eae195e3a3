"""Tensor- and expert-parallel training, its checkpoints and TP serving
across ranks, against ``repro``'s training loop and the port's own runs,
on the CPU.

One 8-rank gloo world (``_torch_dist_workers.tp_ep_train_rank``, the runs
in turn) trains from ``repro``'s seed-0 weights, beside one ``repro``
subprocess on 8 host devices (``_repro_lane_side.py runs``):

  * llama3.2-3b ``--smoke --batch 8 --seq 32 --pods 2`` (a 2 x 2 x 2
    world) with ``--model-parallel 2`` under ``lane`` (also with
    ``--remat full``, whose recomputation runs under the same parallel
    context) and under ``lane_zero3``: the losses within ``TOL`` of
    ``repro``'s training loop with the same flags and of the port's TP = 1 runs,
    the parameters bitwise equal on all 8 ranks;
  * dbrx-132b ``--smoke --batch 8 --seq 16 --pods 2`` (p = 8, E = 8)
    with ``--expert-parallel`` under ``lane`` and under ``lane_zero3``
    (``--ep-blocks`` 1 and 2): the losses within ``TOL`` of the gathered
    MoE run's and of ``repro``'s training loop;
  * checkpoints: a TP = 2 ``lane_zero3`` run resumed from a TP = 1
    checkpoint gives the TP = 1 run's losses (``repro``'s
    ``driver_tp2_restores_tp1_ckpt_bitident``); the expert-parallel
    ``lane_zero3`` checkpoint has ``repro``'s training loop's manifest and its
    values within the two packages' rounding, and resumes ep -> ep and
    ep -> replicated (through the canonical form) with the uninterrupted
    run's loss;
  * TP serving under ``lane_zero3`` (``model_parallel=2`` on a (2 x 2) x
    2 topology): every request's tokens equal replicated hosting's and
    ``repro``'s (``serve_cases._b_tp_serve_identity``).

In the test process: the expert-parallel ``lane_zero3`` checkpoint of one
state (``replicated_to_state`` on both sides, dbrx-132b smoke at 2 x 2)
gives ``arr_<i>.npy`` files byte-identical to ``repro``'s, and both
packages' ep manifests refuse a non-ep restore with the same error.

``TOL``: the losses of the two packages and of the TP / EP layouts differ
only by f32 rounding (summation orders, column-sliced products), 1e-6
relative, as the ZeRO tests hold them.
"""
import dataclasses
import filecmp
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import resolve as jresolve
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.models import init_model as jinit
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import make_scenario as jscenario
from repro_torch.launch import mesh

import _torch_dist_workers as workers
from _torch_dist_workers import (REPRO_SIDE, ROOT, SERVE_MAX_SEQ,
                                 repro_env, save_tree)

TOL = 1e-6
WORLD = 8
LLAMA, DBRX = "llama3.2-3b", "dbrx-132b"
BL = ["--arch", LLAMA, "--smoke", "--batch", "8", "--seq", "32", "--pods",
      "2", "--log-every", "1"]
BD = ["--arch", DBRX, "--smoke", "--batch", "8", "--seq", "16", "--pods",
      "2", "--log-every", "1"]
Z3 = ["--gradsync", "lane_zero3"]
EP = ["--expert-parallel"]
TP2 = ["--model-parallel", "2"]
CPU = ["--device", "cpu"]
CK = ["--ckpt-every", "2"]
# (name, argv, action before it): the port's runs, in turn
RUNS = [
    ("tp1_lane", [*BL, "--steps", "3", "--gradsync", "lane"], None),
    ("tp2_lane", [*BL, "--steps", "3", "--gradsync", "lane", *TP2], None),
    ("tp2_lane_remat", [*BL, "--steps", "3", "--gradsync", "lane", *TP2,
                        "--remat", "full"], None),
    ("tp1_z3", [*BL, "--steps", "4", *Z3, "--ckpt", "{tmp}/tp1", *CK], None),
    ("tp2_z3_from_tp1", [*BL, "--steps", "4", *Z3, *TP2, "--ckpt",
                         "{tmp}/tp2"], ("copy", "{tmp}/tp1", "{tmp}/tp2", 4)),
    ("tp2_z3", [*BL, "--steps", "4", *Z3, *TP2], None),
    ("gather_lane", [*BD, "--steps", "3", "--gradsync", "lane"], None),
    ("ep_lane", [*BD, "--steps", "3", "--gradsync", "lane", *EP], None),
    ("gather_z3", [*BD, "--steps", "3", *Z3], None),
    ("ep_z3", [*BD, "--steps", "3", *Z3, *EP], None),
    ("ep_z3_b2", [*BD, "--steps", "3", *Z3, *EP, "--ep-blocks", "2",
                  "--ckpt", "{tmp}/ep", *CK], None),
    ("ep_to_ep", [*BD, "--steps", "3", *Z3, *EP, "--ckpt", "{tmp}/ep_ep"],
     ("copy", "{tmp}/ep", "{tmp}/ep_ep", 3)),
    ("ep_to_replicated", [*BD, "--steps", "3", "--gradsync", "lane",
                          "--ckpt", "{tmp}/ep_repl"],
     ("copy", "{tmp}/ep", "{tmp}/ep_repl", 3)),
]
# the runs repro's training loop makes too, on 8 host devices, the same flags
# (its checkpoints under {tmp}/repro)
REPRO_RUNS = ("tp2_lane", "tp2_z3", "ep_lane", "ep_z3_b2")
SERVE = (LLAMA, "short_chat", 4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_tp_ep")
    jruns = {n: [a.replace("{tmp}", str(tmp / "repro")) for a in argv]
             for n, argv, _ in RUNS if n in REPRO_RUNS}
    (tmp / "runs.json").write_text(json.dumps(jruns))
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "runs", str(tmp / "runs.json"),
         str(tmp / "repro.json")],
        env=repro_env(WORLD), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        npz, params = {}, {}
        for arch in (LLAMA, DBRX):
            params[arch] = jinit(jax.random.PRNGKey(0),
                                 jresolve(arch, smoke=True))
            npz[arch] = str(tmp / f"{arch}.npz")
            save_tree(npz[arch], jax.tree.map(np.asarray, params[arch]))
        runs = [(n, [*a, *CPU], act) for n, a, act in RUNS]
        ranks = mesh.spawn(workers.tp_ep_train_rank, WORLD, str(tmp), npz,
                           runs, SERVE)
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    want = json.loads((tmp / "repro.json").read_text())
    return tmp, want, ranks, params[LLAMA]


def _losses(ranks, name):
    """The run's losses, the same on every rank; its digests, one."""
    got = {tuple(r[0][name][0]) for r in ranks}
    assert len(got) == 1, (name, got)
    assert len({r[0][name][1] for r in ranks}) == 1, name
    losses = list(got.pop())
    assert losses and all(np.isfinite(losses)), (name, losses)
    return losses


@pytest.mark.parametrize("name,ref", [("tp2_lane", "tp1_lane"),
                                      ("tp2_lane_remat", "tp1_lane"),
                                      ("tp2_z3", "tp1_z3")])
def test_tp2_matches_repro_and_tp1(world, name, ref):
    _, want, ranks, _ = world
    got = _losses(ranks, name)
    np.testing.assert_allclose(got, _losses(ranks, ref), rtol=TOL)
    key = "tp2_lane" if name.startswith("tp2_lane") else name
    np.testing.assert_allclose(got, want[key], rtol=TOL)


@pytest.mark.parametrize("name,ref", [("ep_lane", "gather_lane"),
                                      ("ep_z3", "gather_z3"),
                                      ("ep_z3_b2", "gather_z3")])
def test_ep_matches_gathered_and_repro(world, name, ref):
    _, want, ranks, _ = world
    got = _losses(ranks, name)
    np.testing.assert_allclose(got, _losses(ranks, ref), rtol=TOL)
    np.testing.assert_allclose(got, _losses(ranks, "gather_lane"), rtol=TOL)
    if name in want:
        np.testing.assert_allclose(got, want[name], rtol=TOL)


def test_tp2_restores_tp1_checkpoint(world):
    _, _, ranks, _ = world
    resumed = _losses(ranks, "tp2_z3_from_tp1")
    assert len(resumed) == 2                  # steps 2 and 3
    np.testing.assert_allclose(resumed, _losses(ranks, "tp1_z3")[2:],
                               rtol=TOL)


@pytest.mark.parametrize("name", ["ep_to_ep", "ep_to_replicated"])
def test_ep_checkpoint_resumes(world, name):
    _, _, ranks, _ = world
    resumed = _losses(ranks, name)
    assert len(resumed) == 1                  # step 2
    np.testing.assert_allclose(resumed, _losses(ranks, "ep_z3_b2")[2:],
                               rtol=TOL)


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())


def test_ep_checkpoint_matches_repros_run(world):
    tmp, _, _, _ = world
    got_d, want_d = tmp / "ep" / "step_2", tmp / "repro" / "ep" / "step_2"
    tm, jm = _manifest(got_d), _manifest(want_d)
    assert tm["layout"] == jm["layout"] and tm["layout"]["ep"] is True
    assert [(e["shape"], e["dtype"]) for e in tm["leaves"]] == \
        [(e["shape"], e["dtype"]) for e in jm["leaves"]]
    for i, e in enumerate(jm["leaves"]):
        a = np.load(got_d / f"arr_{i}.npy")
        b = np.load(want_d / f"arr_{i}.npy")
        if e["shape"] == []:                  # the step counts
            assert a == b == 2, i
        else:                                 # as test_torch_train_ckpt's
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6,
                                       err_msg=str(i))


def test_tp_serving_tokens(world):
    _, _, ranks, jparams = world
    arch, kind, slots = SERVE
    cfg = jresolve(arch, smoke=True)
    reqs = jscenario(cfg, kind=kind, n=6, seed=1, max_seq=SERVE_MAX_SEQ)
    done, _ = JBatcher(jparams, cfg, slots=slots,
                       max_seq=SERVE_MAX_SEQ).run(reqs)
    want = {r.rid: [int(t) for t in r.out] for r in done}
    for r in ranks:
        tokens = r[1]
        assert set(tokens) == {"replicated", "lane_zero3 tp1",
                               "lane_zero3 tp2"}
        for label, got in tokens.items():
            assert got == want, label


# ---------------------------------------------------------------------------
# the expert-parallel checkpoint's files, in the test process
# ---------------------------------------------------------------------------

def test_ep_checkpoint_files_match_repro(tmp_path):
    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.bridge import params_from_repro
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import RunConfig, resolve
    from repro_torch.launch import steps
    n, N = 2, 2
    jc, tc = jresolve(DBRX, smoke=True), resolve(DBRX, smoke=True)
    jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(5)
    mom = {k: jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jp) for k in ("m", "v")}
    tp = params_from_repro(jp, tc, device="cpu")
    f32 = dataclasses.replace(tc, dtype="float32")
    tmom = {k: params_from_repro(v, f32, device="cpu")
            for k, v in mom.items()}
    jrun = JRunConfig(model=jc, shape=ShapeConfig("t", 16, 8, "train"),
                      gradsync="lane_zero3", expert_parallel=True)
    trun = RunConfig(model=tc, gradsync="lane_zero3", expert_parallel=True)
    jtree = jsteps.replicated_to_state(jc, jrun, n, N, jp,
                                       {**mom, "count": np.int32(3)},
                                       kind="zero3")
    ttree = steps.replicated_to_state(tc, trun, n, N, tp,
                                      {**tmom, "count": 3}, kind="zero3")
    jlay = jsteps.zero3_checkpoint_layout(jc, n, N, ep=True)
    tlay = steps.zero3_checkpoint_layout(tc, n, N, ep=True)
    jsave(str(tmp_path / "repro"), 3, jtree, jlay)
    save_checkpoint(str(tmp_path / "port"), 3, ttree, tlay)
    jd, td = tmp_path / "repro" / "step_3", tmp_path / "port" / "step_3"
    jm, tm = _manifest(jd), _manifest(td)
    for key in ("step", "layout", "leaves"):
        assert tm[key] == jm[key], key
    assert tm["layout"]["ep"] is True
    for i in range(len(jm["leaves"])):
        assert filecmp.cmp(jd / f"arr_{i}.npy", td / f"arr_{i}.npy",
                           shallow=False), i
    # the flavour is part of the geometry: both refuse a non-ep restore
    non_ep = steps.zero3_checkpoint_layout(tc, n, N)
    with pytest.raises(ValueError) as mine:
        non_ep.check_manifest(tm["layout"])
    with pytest.raises(ValueError) as theirs:
        jsteps.zero3_checkpoint_layout(jc, n, N).check_manifest(
            jm["layout"])
    assert str(mine.value) == str(theirs.value)
