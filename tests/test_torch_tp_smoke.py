"""``repro_torch.launch.tp_smoke`` against ``repro``'s leg: the same five
cells (read from ``repro``'s source with ``ast``: importing its module
sets ``XLA_FLAGS``), all five training, committing and resuming on an
8-rank gloo world, and a TP cell refused, with its reason, on a world
smaller than its degree.  Exact: names, archs, strategies and argv.
"""
import ast

import pytest

from repro_torch.launch import mesh, tp_smoke

from _torch_dist_workers import ROOT


def _repro_cells():
    tree = ast.parse((ROOT / "src/repro/launch/tp_smoke.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "CELLS"
                        for t in n.targets))
    return ast.literal_eval(node.value)


def test_cells_equal_repro():
    assert tp_smoke.CELLS == _repro_cells()
    assert tp_smoke.EP_CELLS == ("ep_lane[moe]", "ep_zero3[moe]",
                                 "ep_zero3_blocks2[moe]")


def test_all_cells_pass_on_eight_ranks(tmp_path):
    fails = mesh.spawn(tp_smoke._sweep_rank, 8, str(tmp_path), timeout=900)
    assert fails == [[]] * 8


def test_tp_cell_needs_its_degree_of_ranks(tmp_path):
    with pytest.raises(ValueError, match="needs --model-parallel 2 ranks"
                       ".*this world has 1"):
        tp_smoke.run_tp_cell("tp2_lane[dense]", str(tmp_path), device="cpu")
