"""The comparison fails what it must, under each cell's own limits.

The control (the reference in float8 in the program's place) against
the reference in float32, at the configurations' published widths cut
to a depth, vocabulary and row a test run holds (granite-moe at width
512, both as cut here, are narrower still).  And every fault a cell can
have, planted underneath the timed path (``perfbench/faults.py``), in
runs of the whole harness on the CPU at the program's ``--smoke`` sizes:
each comes out not correct, and the sound program correct."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench.tests import smoke_root
from perfbench import calibrate, compare, harness, traffic, weights
from perfbench.reference import common

REPO = smoke_root.REPO


@pytest.fixture(autouse=True)
def _few_threads():
    """Two threads a test: the suite runs several workers a host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
FAULTS = {"moe3b.train.4x1024": ("unchanged", "half_batch", "altered"),
          "mamba2.train.8x1024": ("unchanged", "half_batch", "altered"),
          "moe3b.train.lane4.4x1024": ("unchanged", "half_batch", "altered",
                                       "no_exchange")}
# (cell, configuration file, keys changed for the test, seq)
CONTROL = [
    ("mamba2.train.8x1024", "mamba2_780m",
     {"n_layer": 8, "d_model": 512, "vocab_size": 2048}, 256),
    ("moe3b.train.4x1024", "granite_moe_3b_a800m",
     {"num_hidden_layers": 2, "hidden_size": 512, "num_attention_heads": 8,
      "num_key_value_heads": 4, "intermediate_size": 256,
      "attention_multiplier": 0.125, "vocab_size": 2048}, 128),
]


def _cell(name):
    return json.loads((REPO / "perfbench" / "cells" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("cell,config,cut,seq", CONTROL)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_is_not_correct(cell, config, cut, seq, seed):
    cfg = dict(json.loads((REPO / "perfbench" / "configs"
                           / f"{config}.json").read_text()), **cut)
    cfg["token_ids"] = cfg["vocab_size"]
    fam = harness.load_file_module(REPO / "perfbench" / "reference"
                                   / f"{cfg['family']}.py")
    mix = {"kind": "packed_documents", "rows": 1, "seq": seq,
           "doc_len_median": 64, "doc_len_sigma": 1.0, "doc_len_max": 4096,
           "zipf_a": 1.0}
    inp, lab = traffic.packed_rows(mix, cfg, seed, 3)
    rows = [(torch.from_numpy(inp[s]), torch.from_numpy(lab[s]))
            for s in range(3)]
    c = _cell(cell)
    got = {mode: common.train_steps(
        fam, cfg, weights.make_weights(fam.param_specs(cfg), seed, "cpu"),
        rows, c["adamw"], common.Precision(mode)) for mode in ("f32", "fp8")}
    correct, checks = compare.judge(got["fp8"], got["f32"], c["limits"],
                                    c.get("loss_steps"))
    assert not correct, checks


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root.make(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_every_fault_is_not_correct(root, cell):
    c = _cell(cell)
    lines = calibrate.main(
        ["--workload", cell, "--seeds", "21", "--faults",
         ",".join(FAULTS[cell]), "--fault-seeds", "21"],
        root=root, device_type="cpu")
    sides = {line["side"]: line for line in lines}
    assert set(sides) == {"program", *FAULTS[cell]}
    for side, line in sides.items():
        failed = [k for k in compare.NUMBERS if line[k] > c["limits"][k]]
        assert bool(failed) == (side != "program"), (side, line)
