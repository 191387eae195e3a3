"""The port's ``("train_step", strategy)`` registry cells against
``repro``'s: the table, the dispatch through it, the driver's
``--gradsync`` choices derived from it, lanelint keeping it out of the
collective sweep, and ``configs.cells``.

Everything here is exact (names, orders, shape lists); nothing is
numeric.  ``repro.launch.steps`` and ``repro.configs`` are safe to import
in this process (they set no XLA flag).
"""
import pytest

import repro.launch.steps  # noqa: F401 - registers repro's train_step
from repro.comm import strategies_for as jstrategies_for
from repro.configs import all_archs as jall_archs
from repro.configs import cells as jcells
from repro_torch.comm import registry
from repro_torch.comm.registry import ImplEntry
from repro_torch.configs import RunConfig, all_archs, cells, resolve
from repro_torch.launch import steps, train, train_smoke
from repro_torch.optim import AdamWConfig


def test_train_step_table_equals_repro():
    from repro_torch.comm import strategies_for
    assert strategies_for("train_step") == jstrategies_for("train_step")
    assert strategies_for("train_step") == (
        "native", "lane", "lane_pipelined", "lane_int8", "auto",
        "lane_quorum", "lane_zero1", "lane_zero3")


def test_each_registration_builds_its_flavor():
    """The registered builders are the module's, beside which they stand:
    the five replicated names share one, the other three their own."""
    got = {s: registry.get_impl("train_step", s).fn
           for s in registry.strategies_for("train_step")}
    for s in ("native", "lane", "lane_pipelined", "lane_int8", "auto"):
        assert got[s] is steps._build_replicated
    assert got["lane_quorum"] is steps._build_quorum
    assert got["lane_zero1"] is steps._build_zero1
    assert got["lane_zero3"] is steps._build_zero3


def test_build_train_step_resolves_through_the_registry(monkeypatch):
    """A throwaway flavor registered under ``monkeypatch`` is what
    ``build_train_step`` builds, and ``train_smoke``'s derived sweep
    takes it up (no list to edit)."""
    built = []

    def throwaway_step(*args):
        return "the throwaway step"

    def builder(run, opt, comm, single):
        built.append((run.gradsync, comm, single))
        return throwaway_step

    def sync(comm, grads, **kw):
        return grads

    for coll, fn in (("train_step", builder), ("grad_sync", sync)):
        monkeypatch.setitem(registry._REGISTRY[coll], "throwaway",
                            ImplEntry(coll, "throwaway", fn, auto_ok=False))
    run = RunConfig(model=resolve("llama3.2-3b", smoke=True),
                    gradsync="throwaway")
    step = steps.build_train_step(run, AdamWConfig())
    assert step.__wrapped__ is throwaway_step
    assert step() == "the throwaway step"
    assert built == [("throwaway", None, True)]
    assert ("throwaway", "throwaway", "dense", "llama3.2-3b") in \
        train_smoke.cells()


def test_degradations_on_one_batch_axis():
    """replicated -> native, lane_zero1 -> the replicated step, lane_zero3
    raises, as the if-chain did and ``repro`` does."""
    cfg = resolve("llama3.2-3b", smoke=True)
    step = steps.build_train_step(RunConfig(model=cfg, gradsync="lane_zero1"),
                                  AdamWConfig(), single=True)
    assert step.full_params("p") == "p"
    with pytest.raises(ValueError, match="distinct lane and node"):
        steps.build_train_step(RunConfig(model=cfg, gradsync="lane_zero3"),
                               AdamWConfig(), single=True)


def test_gradsync_choices_come_from_the_registry(capsys):
    with pytest.raises(SystemExit) as e:
        train.run(["--arch", "llama3.2-3b", "--smoke", "--gradsync",
                   "bogus", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'bogus'" in err
    for s in jstrategies_for("train_step"):
        assert s in err


def test_lanelint_sweep_skips_the_train_step_table():
    from repro_torch.analysis.rules import COMM_COLLECTIVES, iter_cell_cases
    assert "train_step" in registry.registered_collectives()
    assert "train_step" not in COMM_COLLECTIVES
    assert not [c for c in iter_cell_cases()
                if c.collective == "train_step"]


def test_cells_equal_repro_for_every_arch():
    assert all_archs() == jall_archs()
    assert len(all_archs()) == 10
    for arch in all_archs():
        assert cells(arch) == jcells(arch), arch
