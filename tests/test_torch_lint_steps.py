"""lanelint's step sweep: one 8-rank gloo world (2 pods of 4) runs a
``lane_pipelined`` and a ``lane_zero3`` train step of llama3.2-3b
``--smoke`` and one ``lane_zero3`` serve prefill, splice and decode under
the collective recorder; R1 holds on every rank's footprint."""
from repro_torch.analysis.rules import check_step_footprint
from repro_torch.analysis.steps import STEP_NAMES, sweep_steps


def test_r1_is_clean_on_the_steps():
    swept = sweep_steps()
    assert tuple(swept) == STEP_NAMES
    for name, feet in swept.items():
        assert len(feet) == 8
        assert check_step_footprint(name, feet) == [], name
        levels = {lv for f in feet for lv in f.levels()}
        # every step moves bytes at both levels; the serve steps issue
        # nothing whole-world, the train steps only their scalar loss
        assert {"node", "lane"} <= levels, (name, levels)
        if name.startswith("serve_step"):
            assert "global" not in levels, name
        else:
            assert all(op.result_bytes <= 8 for f in feet for op in f.ops
                       if op.level == "global"), name
