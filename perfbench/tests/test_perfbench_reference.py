"""The plain reference computes what the program computes: at the
program's ``--smoke`` sizes, in float32 on the CPU, the same loss and the
same gradient of every parameter, from the benchmark's weights and rows;
and its AdamW moves the parameters as the program's does."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench.tests import smoke_root
from perfbench import harness, traffic, weights
from perfbench.reference import common

CONFIGS = ("granite_moe_3b_a800m", "mamba2_780m")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two threads a test: the suite runs several workers a host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(name, seed=3):
    cfg = smoke_root.smoke_config(json.loads(
        (smoke_root.REPO / "perfbench" / "configs" / f"{name}.json")
        .read_text()))
    fam = harness.load_file_module(smoke_root.REPO / "perfbench"
                                   / "reference" / f"{cfg['family']}.py")
    w = weights.make_weights(fam.param_specs(cfg), seed, "cpu")
    mix = {"kind": "packed_documents", "rows": 2, "seq": 24,
           "doc_len_median": 10, "doc_len_sigma": 1.0, "doc_len_max": 64,
           "zipf_a": 1.0}
    inp, lab = traffic.packed_rows(mix, cfg, seed, 3)
    return cfg, fam, w, torch.from_numpy(inp), torch.from_numpy(lab)


def _program(cfg, w):
    from repro_torch.configs import resolve
    drv = harness.load_file_module(smoke_root.REPO / "perfbench" / "drivers"
                                   / "train_step.py")
    prog = resolve(cfg["program"]["arch"], smoke=True)
    return prog, drv.program_tree(prog, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_program(name):
    from repro_torch import _tree
    from repro_torch.models.transformer import loss_fn
    cfg, fam, w, inp, lab = _setup(name)
    prog, tree = _program(cfg, w)
    leaves = [t.requires_grad_(True) for t in _tree.leaves(tree)]
    names = [".".join(map(str, p)) for p, _ in _tree.flatten(tree)]
    lp = loss_fn(tree, prog, inp[0], lab[0])
    gp = dict(zip(names, torch.autograd.grad(lp, leaves)))
    params = common.as_f32(w)
    lr = fam.loss(params, cfg, inp[0], lab[0], common.Precision("f32"),
                  layer_call=common._layer_checkpoint)
    gr = dict(zip(params, torch.autograd.grad(lr, list(params.values()),
                                               materialize_grads=True)))
    assert float(lr.detach()) == pytest.approx(float(lp.detach()), rel=1e-6)
    for k in names:
        scale = float(gr[k].abs().max()) + 1e-12
        assert float((gp[k] - gr[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", CONFIGS)
def test_three_steps_match_the_program(name):
    """The reference's three steps against the program's step from the
    same weights and rows: losses and every parameter after the steps."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch import _tree
    cfg, fam, w, inp, lab = _setup(name, seed=9)
    prog, tree = _program(cfg, w)
    cell = json.loads((smoke_root.REPO / "perfbench" / "cells"
                       / "mamba2.train.8x1024.json").read_text())
    opt = cell["adamw"]
    run = RunConfig(model=prog)
    step = S.build_train_step(run, AdamWConfig(**opt))
    params, state, _ = S.init_lane_train_state(run, tree, device="cpu")
    losses = []
    for s in range(3):
        loss, params, state = step(params, state, inp[s], lab[s])
        losses.append(float(loss))
    got = common.train_steps(fam, cfg, w, [(inp[s], lab[s])
                                           for s in range(3)],
                             opt, common.Precision("f32"))
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    for path, p in _tree.flatten(params):
        k = ".".join(map(str, path))
        want = float((p.detach() - w[k]).norm())
        assert got["change"][k] == pytest.approx(want, rel=1e-3,
                                                 abs=1e-7), k


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = common.Precision("fp8").q(x)
    err = float((y - x).detach().abs().max())
    assert 0 < err <= 3 * 2 ** -3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert common.Precision("f32").q(x) is x
