"""lanelint's cell sweep on 8-rank gloo worlds, one per grid topology:
every registered ``(collective, strategy)`` cell of the port runs under
the collective recorder, and R1–R4 hold on what it issued; live negative
controls in the same worlds give their findings.  The recorder runs only
inside the spawned ranks (``_torch_dist_workers.lint_cells_rank``)."""
import pytest

from repro.analysis.rules import iter_cell_cases as repro_cases
from repro_torch.analysis.rules import (CellCase, GRID, LOCAL_ELEMS,
                                        PIPELINED_CELLS, R4_CONTROL_CELLS,
                                        check_cell, iter_cell_cases)
from repro_torch.launch.mesh import spawn

import _torch_dist_workers as workers


@pytest.fixture(scope="module", params=GRID, ids=lambda t: f"n{t[0]}xN{t[1]}")
def world(request):
    n, N = request.param
    ranks = spawn(workers.lint_cells_rank, n * N, n, N)
    return n, N, ranks


def test_the_sweep_is_repros():
    """The port sweeps exactly ``repro``'s cells, so none is skipped."""
    import repro.comm.impls  # noqa: F401  — populate repro's registry
    key = lambda c: (c.collective, c.strategy, c.n, c.N, c.payload_bytes,
                     c.kw)
    assert sorted(map(key, iter_cell_cases())) == \
        sorted(map(key, repro_cases()))
    assert len(list(iter_cell_cases())) == 68


def test_every_cell_is_clean(world):
    n, N, ranks = world
    for case in iter_cell_cases(((n, N),)):
        feet = [cells[case.target] for cells, _, _ in ranks]
        assert all(len(f) for f in feet), case.target   # it issued calls
        assert check_cell(case, feet) == [], case.target


def test_r4_overlap_and_its_control(world):
    """The five pipelined cells have a node and a lane phase in flight
    together on every rank; the blocking control on none."""
    from repro_torch.analysis import overlap
    n, N, ranks = world
    seen = set()
    for case in iter_cell_cases(((n, N),)):
        key = (case.collective, case.strategy)
        feet = [cells[case.target] for cells, _, _ in ranks]
        if key in PIPELINED_CELLS:
            assert all(overlap(f) for f in feet), case.target
            seen.add(key)
        elif key in R4_CONTROL_CELLS:
            assert not any(overlap(f) for f in feet), case.target
            seen.add(key)
    assert seen == PIPELINED_CELLS | R4_CONTROL_CELLS


def test_live_negative_controls(world):
    n, N, ranks = world
    c = LOCAL_ELEMS * 4
    whole = check_cell(CellCase("allreduce", "lane", n, N, c),
                       [ctl["whole_world"] for _, ctl, _ in ranks])
    # R1 and R2 (and R3: the lane cost prices node and lane phases that
    # the cell no longer has)
    assert sorted({f.rule for f in whole}) == ["R1", "R2", "R3"]
    assert any("whole-world all-reduce" in f.message for f in whole)
    serial = check_cell(CellCase("allreduce", "lane_pipelined", n, N, c,
                                 (("num_blocks", 4),)),
                        [ctl["serial"] for _, ctl, _ in ranks])
    assert "R4" in {f.rule for f in serial}
    assert all(f.message.startswith("rank 0: ") for f in serial
               if f.rule == "R4")


def test_the_recorder_restores_torch_distributed(world):
    assert all(restored for _, _, restored in world[2])
