"""The port's config registry equals ``repro``'s, field for field."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg

ARCHS = jcfg.all_archs()


def test_same_arch_list():
    assert tcfg.all_archs() == ARCHS


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch, smoke):
    want = jcfg.resolve(arch, smoke=smoke)
    got = tcfg.resolve(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd() == want.hd()
    assert got.param_count() == want.param_count()
    assert got.param_count(active_only=True) == \
        want.param_count(active_only=True)


def test_shapes_equal():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tcfg.resolve("no-such-arch")


def _run_error(make, **kw):
    try:
        make(**kw)
    except ValueError as e:
        return str(e)
    return None


# the third axis's validation: (gradsync, arch, RunConfig keywords)
RUN_ERRORS = [
    ("lane_zero1", "llama3.2-3b", {"model_parallel": 2}),
    ("lane_quorum", "llama3.2-3b", {"model_parallel": 2}),
    ("lane", "llama3.2-3b", {"model_parallel": 0}),
    ("lane", "llama3.2-3b", {"ep_blocks": 0}),
    ("lane", "llama3.2-3b", {"expert_parallel": True}),
    ("lane_quorum", "dbrx-132b", {"expert_parallel": True}),
]


@pytest.mark.parametrize("gradsync,arch,kw", RUN_ERRORS,
                         ids=[f"{g}-{a}-{next(iter(k))}"
                              for g, a, k in RUN_ERRORS])
def test_run_config_third_axis_errors_equal_repros(gradsync, arch, kw):
    """``RunConfig``'s TP/EP validation raises ``repro``'s errors."""
    want = _run_error(lambda **k: jcfg.RunConfig(
        model=jcfg.resolve(arch, smoke=True), shape=jcfg.SHAPES["train_4k"],
        gradsync=gradsync, **k), **kw)
    got = _run_error(lambda **k: tcfg.RunConfig(
        model=tcfg.resolve(arch, smoke=True), gradsync=gradsync, **k), **kw)
    assert want is not None and got == want


def test_run_config_third_axis_accepted():
    cfg = tcfg.resolve("dbrx-132b", smoke=True)
    run = tcfg.RunConfig(model=cfg, gradsync="lane_zero3", model_parallel=2,
                         expert_parallel=True, ep_blocks=2)
    assert (run.model_parallel, run.expert_parallel, run.ep_blocks) == \
        (2, True, 2)
