"""The result line: exactly the contract's keys, in a run of the whole
harness on the CPU (with the check for a card skipped); and ``run.py``
without a card exits non-zero and prints no result."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench.tests import smoke_root
from perfbench import harness

DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root.make(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(root, trace):
    rec, result = harness.run(root, "moe3b.train.4x1024", 2**31 + 9, 0.3,
                              trace, "cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"] \
        + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert set(result["device"]) == DEVICE | (
        {"busy_s", "window_s"} if trace else set())
    assert result["device"]["count"] == 1
    assert isinstance(result["correct"], bool)
    assert result["metrics"] == {}       # a CPU run writes no device metric
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for c in result["checks"].values():
        assert {"value", "limit"} <= set(c)
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    json.loads(json.dumps(result))


def test_readers_read_a_record(root):
    """Every reader turns a run's record into a number where the record
    has what it reads (read here on the CPU record, never printed)."""
    rec, _ = harness.run(root, "mamba2.train.8x1024", 4, 0.3, False, "cpu")
    ctx = harness.make_context(root, "mamba2.train.8x1024", 4, 0.3, False,
                               "cuda")
    rec = dict(rec, device_kind="NVIDIA H100 80GB HBM3")
    got = harness.read_metrics(ctx, rec)
    assert set(got) == {"train_tokens_per_s", "train_mfu", "setup_s"}
    assert got["train_tokens_per_s"]["value"] == pytest.approx(
        rec["window"]["tokens"] / rec["window"]["seconds"])


def test_run_without_a_card_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, str(smoke_root.REPO / "perfbench" / "run.py"),
         "--workload", "moe3b.train.4x1024", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=env, cwd=smoke_root.REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
