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
