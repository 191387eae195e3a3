"""The serving smoke leg of the port (``repro_torch.serve.serve_smoke``)
and the registries it derives its sweep from, against ``repro``'s."""
import numpy as np
import pytest

from repro.comm.registry import strategies_for as j_strategies_for
from repro.configs import resolve as j_resolve
from repro.serve import SCENARIO_KINDS as J_KINDS
from repro.serve import make_scenario as j_make_scenario
from repro.serve import scenario_families as j_scenario_families
from repro.serve import serve_hostings as j_serve_hostings
from repro_torch.configs import resolve
from repro_torch.models.blockstack import block_stack_families
from repro_torch.serve import (SCENARIO_KINDS, build_serve_step,
                               make_scenario, scenario_families,
                               serve_hostings)

ARCH_OF = {"dense": "llama3.2-3b", "moe": "granite-moe-3b-a800m",
           "ssm": "mamba2-780m", "hybrid": "zamba2-7b",
           "vlm": "llava-next-mistral-7b", "audio": "whisper-large-v3"}


def test_the_registries_are_repros():
    assert serve_hostings() == j_serve_hostings() == \
        ("replicated", "lane_zero3")
    assert scenario_families() == j_scenario_families()
    assert set(scenario_families()) == set(block_stack_families())
    assert set(j_strategies_for("serve_scenario")) == \
        set(j_strategies_for("block_stack"))
    assert SCENARIO_KINDS == J_KINDS


def test_an_unregistered_hosting_names_the_registered_ones():
    with pytest.raises(ValueError, match=r"registered: \('replicated', "
                                         r"'lane_zero3'\)"):
        build_serve_step(resolve("llama3.2-3b", smoke=True), max_seq=32,
                         slots=2, hosting="sharded", device="cpu")


@pytest.mark.parametrize("family", sorted(ARCH_OF))
def test_every_familys_requests_are_repros(family):
    """Through the registry cells, byte-identical requests, extras
    included, for every kind."""
    arch = ARCH_OF[family]
    cfg, jcfg = resolve(arch, smoke=True), j_resolve(arch, smoke=True)
    max_seq = 96 + (cfg.vision_tokens if family == "vlm" else 0)
    for kind in SCENARIO_KINDS:
        mine = make_scenario(cfg, kind=kind, n=5, seed=3, max_seq=max_seq)
        theirs = j_make_scenario(jcfg, kind=kind, n=5, seed=3,
                                 max_seq=max_seq)
        assert len(mine) == len(theirs) == 5
        for a, b in zip(mine, theirs):
            assert (a.rid, a.max_new_tokens, a.arrival_step) == \
                (b.rid, b.max_new_tokens, b.arrival_step)
            assert np.asarray(a.prompt).tobytes() == \
                np.asarray(b.prompt).tobytes()
            if b.extra is None:
                assert a.extra is None
            else:
                assert np.asarray(a.extra).tobytes() == \
                    np.asarray(b.extra).tobytes()


def test_serve_smoke_passes_on_the_cpu(capsys):
    from repro_torch.serve.serve_smoke import main
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for leg in ("scenario_sweep[dense,ssm]", "ckpt_to_serve[dense]",
                "zero3_identity[dense]"):
        assert f"PASS {leg}" in out
    assert "replicated == lane_zero3 on 2 x 2 ranks" in out
