"""The program's spans and counters (``repro_torch.obs``) and the
benchmark's readers of them, on the CPU, one process.

* Off (no profiler): ``obs.span`` opens no range, ``obs.count`` counts
  nothing and the MoE block builds no marker node.
* On: a ``--smoke`` granite-moe step yields ``train_step`` and its
  forward, backward (the backward's autograd nodes its children) and
  optimizer, and per layer ``moe/forward`` and ``moe/backward`` (the
  combine's index backward inside); ``bucket_schedule`` opens each named
  stage's span once a bucket at launch, and once more at finish for a
  stage that returns one; an unnamed stage opens none.
* ``moe.assigned`` / ``moe.kept`` equal B·T·K and ``keep.sum()``.
* Each new reader under ``perfbench/layer_metrics/`` reads a synthetic
  record as computed by hand, and nothing off the card.
* Every span and counter named in ``src/repro_torch/`` is read by a
  reader or listed in PERF.md's section 3.
"""
from __future__ import annotations

import collections
import dataclasses
import pathlib
import re
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import RunConfig, resolve
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models import init_model
from repro_torch.models import moe as M
from repro_torch.optim import AdamWConfig
from repro_torch.optim import gradsync as G

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True)
def _clean_counters():
    obs.reset_counters()
    yield
    obs.reset_counters()


@pytest.fixture(scope="module")
def granite():
    """(cfg, step, params, opt_state, tokens, labels) at smoke size."""
    cfg = resolve(ARCH, smoke=True)
    step = build_train_step(RunConfig(model=cfg), AdamWConfig())
    params, state = init_train_state(init_model(cfg, device="cpu"),
                                     device="cpu")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    return cfg, step, params, state, toks, labels


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def _counting_ranges(monkeypatch) -> list:
    opened = []
    real = obs.record_function

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(obs, "record_function", counted)
    return opened


def test_off_no_range_no_count_no_marker(granite, monkeypatch):
    cfg, step, params, state, toks, labels = granite
    opened = _counting_ranges(monkeypatch)
    assert not obs.recording()
    with obs.span("x") as got:
        assert got is None
    step(params, state, toks, labels)
    obs.count("c", 5)
    obs.count("c", torch.ones(3, dtype=torch.bool))
    assert opened == [] and obs.counters() == {}
    lp = params["blocks"][0]["moe"]
    x = torch.randn(1, 8, cfg.d_model, requires_grad=True)
    out, _ = M.moe_block(lp, x, cfg)
    assert type(out.grad_fn).__name__ != "_OpenBackward"
    with profile(activities=[ProfilerActivity.CPU]):
        out, _ = M.moe_block(lp, x, cfg)
        assert type(out.grad_fn).__name__ == "_OpenBackward"
        out.sum().backward()
    assert opened.count("moe/forward") == 1
    assert opened.count("moe/backward") == 1


def test_step_spans_under_the_profiler(granite):
    cfg, step, params, state, toks, labels = granite
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, toks, labels)
    ev = prof.events()
    by = collections.defaultdict(list)
    for e in ev:
        by[e.name].append(e)
    for name in ("train_step", "train_step/forward", "train_step/backward",
                 "train_step/optimizer"):
        assert len(by[name]) == 1, name
    (top,) = by["train_step"]
    assert [c.name for c in top.cpu_children if "/" in c.name] == [
        "train_step/forward", "train_step/backward", "train_step/optimizer"]
    (bwd,) = by["train_step/backward"]
    nodes = [c.name for c in bwd.cpu_children
             if c.name.startswith("autograd::engine::evaluate_function")]
    assert len(nodes) > 50
    L = cfg.num_layers
    assert len(by["moe/forward"]) == len(by["moe/backward"]) == L
    for e in by["moe/forward"]:
        assert e.cpu_parent is not None
    for e in by["moe/backward"]:
        assert e.cpu_parent.name == "train_step/backward"
        inside = [d.name for d in _descendants(e)]
        assert any("IndexBackward0" in n for n in inside)
    # every gather backward of the step is the MoE's, and all lie inside
    idx = [e for e in _descendants(bwd) if e.name.startswith(
        "autograd::engine::evaluate_function: Index")]
    inside = {id(d) for m in by["moe/backward"] for d in _descendants(m)}
    assert idx and all(id(e) in inside for e in idx)


def test_bucket_schedule_opens_each_named_stage_per_bucket():
    K = 3

    def a(v):
        v.mul_(2)

    def b(v):
        return lambda: v.add_(1)

    def unnamed(v):
        v.sub_(3)
    a, b = G._stage("a_hop", a), G._stage("b_hop", b)
    flat = torch.arange(12.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.bucket_schedule(flat, K, (a, b, unnamed))
    names = collections.Counter(e.name for e in prof.events())
    assert names["grad_sync/a_hop"] == K
    assert names["grad_sync/b_hop"] == 2 * K      # launch and finish
    assert {n for n in names if n.startswith("grad_sync/")} == {
        "grad_sync/a_hop", "grad_sync/b_hop"}     # the unnamed: no span
    assert torch.equal(flat, torch.arange(12.0) * 2 + 1 - 3)


def test_moe_counters_equal_the_dispatch():
    cfg = dataclasses.replace(resolve(ARCH, smoke=True),
                              moe_capacity_factor=0.25)
    p = init_model(cfg, device="cpu")["blocks"][0]["moe"]
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, keep, _, _, _ = M._dispatch_buffer(p, x, cfg)
        _, _, keep2, _, _, _ = M._dispatch_buffer(p, x[:1], cfg)
    got = obs.counters()
    B, T, K = 2, 64, cfg.experts_per_token
    assert got["moe.assigned"] == B * T * K + T * K
    assert got["moe.kept"] == int(keep.sum()) + int(keep2.sum())
    assert 0 < got["moe.kept"] < got["moe.assigned"]
    assert all(type(v) is int for v in got.values())


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _reader(name):
    from perfbench import harness
    return harness.load_file_module(
        REPO / "perfbench" / "layer_metrics" / f"{name}.py")


RANGES = {"train_step": 1.2, "train_step/forward": 0.15,
          "train_step/backward": 0.6, "train_step/grad_sync": 0.3,
          "train_step/optimizer": 0.12, "train_step/loss_mean": 0.03,
          "grad_sync/rs_node": 0.06, "grad_sync/ag_node": 0.045,
          "grad_sync/ar_lane": 0.09, "grad_sync/flatten": 0.03,
          "grad_sync/unflatten": 0.036, "moe/forward": 0.09,
          "moe/backward": 0.3, "attention_backward": 0.24,
          "ssd_backward": 0.6}
WANT = {"bwd_span_device_ms": 200.0,
        "unspanned_device_ms": 415.0 - 50.0 - 200.0 - 100.0 - 40.0,
        "sync_wait_ms": 10.0, "sync_node_ms": 35.0, "sync_lane_ms": 30.0,
        "sync_copy_ms": 22.0, "moe_device_ms": 130.0,
        "attn_bwd_device_ms": 80.0, "ssd_bwd_device_ms": 200.0}


def _rec(ranges, kernel_sum_s=1.245):
    return {"trace": {"ranges": dict(ranges), "kernel_sum_s": kernel_sum_s},
            "trace_steps": 3}


CARD, CPU = (types.SimpleNamespace(device_type=d) for d in ("cuda", "cpu"))


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_read_a_record(name):
    r = _reader(name)
    assert r.read(_rec(RANGES), CARD) == pytest.approx(WANT[name])
    assert r.read(_rec(RANGES), CPU) is None
    assert r.read({"trace_steps": 3}, CARD) is None
    assert r.read(_rec({}), CARD) is None


@pytest.mark.parametrize("name", ["bwd_span_device_ms",
                                  "unspanned_device_ms"])
def test_readers_need_the_step_range(name):
    """A program whose step has no ``train_step`` range ran its backward
    outside its range: these read nothing there."""
    parent = {k: v for k, v in RANGES.items() if k != "train_step"}
    assert _reader(name).read(_rec(parent), CARD) is None


def test_lane_reader_takes_every_lane_stage():
    r = _reader("sync_lane_ms")
    got = r.read(_rec({"grad_sync/ar_lane_int8": 0.03,
                       "grad_sync/rs_lane": 0.06}), CARD)
    assert got == pytest.approx(30.0)


def test_drop_reader_reads_the_counters():
    r = _reader("moe_drop_pct")
    assert r.read(_rec(RANGES), CARD) is None          # nothing counted
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("moe.assigned", 200)
        obs.count("moe.kept", torch.arange(200) < 170)
    assert r.read(_rec(RANGES), CARD) == pytest.approx(15.0)
    assert r.read(_rec(RANGES), CPU) is None
    assert r.read({"trace_steps": 3}, CARD) is None


# ---------------------------------------------------------------------------
# every span and counter is read
# ---------------------------------------------------------------------------

SPAN_CALLS = (
    (re.compile(r'obs\.span\(\s*"([^"]+)"'), ""),
    (re.compile(r'backward_(?:span|until_end)\(\s*"([^"]+)"'), ""),
    (re.compile(r'_stage\(\s*"([^"]+)"'), "grad_sync/"),
)
COUNT_CALL = re.compile(r'obs\.count\(\s*"([^"]+)"')


def _program_names():
    spans, counts = set(), set()
    for f in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = f.read_text()
        for pat, prefix in SPAN_CALLS:
            spans.update(prefix + n for n in pat.findall(text))
        counts.update(COUNT_CALL.findall(text))
    return spans, counts


def _perf_section3() -> str:
    text = (REPO / "PERF.md").read_text()
    return text.split("## 3.", 1)[1].split("## 4.", 1)[0]


def _value(reader, ranges):
    """A reader's value on a record holding only ``ranges``; readers of
    other parts of the record fail on it and read nothing."""
    try:
        return reader.read(_rec(ranges), CARD)
    except (KeyError, AttributeError, TypeError):
        return None


def test_every_span_and_counter_is_read():
    spans, counts = _program_names()
    assert {"train_step", "train_step/backward", "moe/backward",
            "grad_sync/ar_lane", "grad_sync/flatten"} <= spans
    assert counts == {"moe.assigned", "moe.kept"}
    readers = [_reader(p.stem) for p in sorted(
        (REPO / "perfbench" / "layer_metrics").glob("*.py"))]
    listed = _perf_section3()
    for name in sorted(spans):
        read = any(_value(r, {**base, name: 1.0}) != _value(r, base)
                   for base in ({}, {"train_step": 1.0}) for r in readers)
        assert read or f"`{name}`" in listed, \
            f"span {name!r}: no reader reads it, PERF.md section 3 omits it"
    texts = "".join(p.read_text() for p in
                    (REPO / "perfbench" / "layer_metrics").glob("*.py"))
    for name in counts:
        assert f'"{name}"' in texts or f"`{name}`" in listed, name
