"""moe_device_ms: the device time of the MoE blocks, a traced step (rank
0): the program's ``moe/forward`` and ``moe/backward`` ranges (routing,
dispatch, the experts' products and the combine, and their backward, in
every layer) summed."""
from perfbench.readers import per_step_ms

PARTS = ("forward", "backward")


def read(rec, ctx):
    got = [per_step_ms(rec, ctx, f"moe/{p}") for p in PARTS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
