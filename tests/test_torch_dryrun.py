"""``repro_torch.launch.dryrun``, the planner, against ``repro``'s
dry-run decisions and against what the port's steps really do.

  * ``list_cells`` equals ``repro``'s, and for every cell of both
    production meshes under both plans, ``plan``'s fsdp / remat /
    microbatch and ``input_shapes`` equal ``repro``'s ``plan`` and
    ``input_specs`` (``repro``'s side in a subprocess with 512 host
    devices, ``_repro_lane_side.py plan``: its module sets XLA_FLAGS);
  * ``train_flops`` against ``torch.utils.flop_counter.FlopCounterMode``
    over one CPU train step of a smoke config: equal to 1e-9 once the
    known differences are added (the plain attention computes the whole
    T x T score square, the closed form the pairs the causal or window
    mask keeps; and 6 N counts the norm weights and an untied embedding
    table, which no product uses);
  * for one recorded step on an 8-rank gloo world (2 pods) of smoke
    llama3.2-3b under ``lane``, ``lane_zero3`` (remat full, 2
    microbatches), the same with ``--model-parallel 2``, ``native`` and
    ``lane_pipelined``, the planned per-kind counts and bytes and the
    per-level wire equal what ``analysis.record_collectives`` records,
    exactly, but for the one-element scalars (the loss mean, the norm)
    the planner leaves out;
  * ``train_state_bytes`` equals the bytes ``init_lane_train_state``
    returns on the CPU for every layout;
  * ``--all --both-meshes`` writes every one of the 66 planned cells.
"""
import collections
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import SHAPES, RunConfig, ShapeConfig, resolve
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.mesh import MeshSpec

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env


@pytest.fixture(scope="module")
def repro_plans(tmp_path_factory):
    out = tmp_path_factory.mktemp("plan") / "plan.json"
    subprocess.run([sys.executable, str(REPRO_SIDE), "plan", str(out)],
                   env=repro_env(512), cwd=ROOT, check=True, timeout=600)
    return json.loads(out.read_text())


def test_list_cells_equal_repro(repro_plans, capsys):
    assert [list(r) for r in dryrun.list_cells()] == repro_plans["cells"]
    assert dryrun.main(["--list"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 40 and sum("SKIP" in r for r in rows) == 7


def test_plans_and_input_shapes_equal_repro(repro_plans):
    seen = 0
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        for arch, shape, st in dryrun.list_cells():
            if st != "run":
                continue
            cfg = resolve(arch)
            for plan_name in ("default", "tp0"):
                want = repro_plans["plans"][
                    f"{arch}|{shape}|{int(multi)}|{plan_name}"]
                pl = dryrun.plan(cfg, SHAPES[shape], m, plan_name=plan_name)
                key = (arch, shape, multi, plan_name)
                assert pl.fsdp == want["fsdp"], key
                assert pl.run.remat == want["remat"], key
                assert pl.run.microbatch == want["microbatch"], key
                assert pl.run.gradsync == ("lane_zero3" if pl.fsdp
                                           else want["gradsync"]), key
                assert pl.tp == (1 if plan_name == "tp0" else 16), key
                got = {k: None if v is None else [list(v[0]), v[1]]
                       for k, v in dryrun.input_shapes(
                           cfg, SHAPES[shape]).items()}
                assert got == want["inputs"], key
                seen += 1
    assert seen == 2 * 2 * 33


@pytest.mark.parametrize("arch", ["llama3.2-3b", "h2o-danube-3-4b"])
def test_train_flops_match_the_flop_counter(arch):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    cfg = resolve(arch, smoke=True)
    B, T = 2, 96
    step = build_train_step(RunConfig(model=cfg), AdamWConfig())
    params, opt = init_train_state(init_model(cfg, seed=0, device="cpu"),
                                   device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int64))
    with torch.enable_grad(), FlopCounterMode(display=False) as fc:
        step(params, opt, toks[:, :-1], toks[:, 1:])
    pairs = dryrun.attention_pairs(T, T, True, cfg.sliding_window)
    square = 3 * 4 * cfg.hd() * cfg.num_heads * cfg.num_layers * B \
        * (T * T - pairs)
    norms = sum(t.numel() for path, t in _tree.flatten(params)
                if any("norm" in str(k) or str(k).startswith("ln")
                       for k in path))
    lookup = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    want = dryrun.train_flops(cfg, B, T) + square \
        - 6 * (norms + lookup) * B * T
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)


CASES = [("lane", 1, 16, 32, "full", 2), ("lane_zero3", 1, 16, 32, "full", 2),
         ("lane", 2, 8, 32, "full", 2), ("lane_zero3", 2, 8, 32, "full", 2),
         ("native", 1, 8, 32, "none", 0),
         ("lane_pipelined", 1, 8, 32, "none", 0)]


def test_planned_collectives_equal_the_recorder():
    ranks = mesh.spawn(workers.planned_steps_rank, 8, CASES, timeout=900)
    cfg = resolve("llama3.2-3b", smoke=True)
    for ci, (gs, tp, batch, seq, remat, mb) in enumerate(CASES):
        for rank, res in enumerate(ranks):
            ops, (n, N), idx = res[ci]
            run = RunConfig(model=cfg, gradsync=gs, model_parallel=tp,
                            remat=remat, microbatch=mb)
            pl = dryrun.Plan(run, ShapeConfig("smoke", seq, batch, "train"),
                             MeshSpec(("pod", "data", "model"), (N, n, tp)),
                             False, "default", n, N, tp, None, ())
            want = dryrun.step_collectives(pl, rank_idx=idx)
            kinds = collections.defaultdict(lambda: [0, 0.0])
            level = collections.Counter()
            scalars = 0
            for kind, lv, payload, result, wire in ops:
                if payload == 0:      # a stripe holding no TP weight
                    continue
                if payload == 4:      # one f32 element
                    scalars += 1
                    continue
                kinds[kind][0] += 1
                kinds[kind][1] += result
                level[lv] += wire
            key = (gs, tp, rank)
            assert scalars == (2 if gs == "lane_zero3" else 1), key
            assert dict(kinds) == {k: [v["count"], v["bytes"]] for k, v in
                                   want["per_kind"].items()}, key
            assert level["node"] == want["node_wire_bytes"] \
                + want["model_wire_bytes"], key
            assert level["lane"] == want["lane_wire_bytes"], key
            assert level["global"] == want["global_wire_bytes"], key
            assert sum(v["wire_bytes"] for v in want["per_kind"].values()) \
                == pytest.approx(sum(level.values()), rel=1e-12), key


@pytest.mark.parametrize("arch,gradsync,ep", [
    ("llama3.2-3b", "lane", False), ("llama3.2-3b", "lane_zero1", False),
    ("llama3.2-3b", "lane_zero3", False), ("zamba2-7b", "lane_zero3", False),
    ("granite-moe-3b-a800m", "lane_zero3", True)])
def test_train_state_bytes_equal_the_state(arch, gradsync, ep):
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.launch.steps import (_local_topology,
                                          init_lane_train_state)
    from repro_torch.models import init_model
    cfg = resolve(arch, smoke=True)
    run = RunConfig(model=cfg, gradsync=gradsync, expert_parallel=ep)
    comm = LaneComm(_local_topology(), CommConfig.from_run(run))
    params, opt, _ = init_lane_train_state(
        run, init_model(cfg, seed=0, device="cpu"), comm, single=False,
        device="cpu")
    have = sum(t.numel() * t.element_size()
               for t in _tree.leaves({"p": params, "o": opt})
               if isinstance(t, torch.Tensor))
    want = dryrun.train_state_bytes(run, 1, 1)
    assert sum(want.values()) == have
    assert (want["masters"] > 0) == (gradsync == "lane_zero3")
    assert (want["experts"] > 0) == ep


def test_all_writes_every_cell(tmp_path, capsys):
    assert dryrun.main(["--all", "--both-meshes", "--out",
                        str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*/*.json"))
    assert len(files) == 66
    for f in files:
        r = json.loads(f.read_text())
        assert r["flops"] > 0 and r["state_bytes"]["total"] > 0
        assert {"node_wire_bytes", "lane_wire_bytes"} <= set(r["collectives"])
        assert r["hosts"] * 8 == r["chips"]
    multi = json.loads((tmp_path / "multi" /
                        "qwen1.5-110b__train_4k.json").read_text())
    assert multi["gradsync"] == "lane_zero3" and multi["fsdp"]
    assert multi["topology"] == {"n": 16, "N": 2, "tp": 16}
    assert multi["crosses_host"] == {"node": True, "lane": True,
                                     "model": True}
    assert multi["collectives"]["lane_wire_bytes"] > 0
    assert "FAILED CELLS: none" in capsys.readouterr().out
