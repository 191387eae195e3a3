"""sync_node_ms: the device time of the gradient sync's node hops, a
traced step (rank 0): the program's ``grad_sync/rs_node`` and
``grad_sync/ag_node`` ranges (the reduce-scatter and the all-gather
inside a node group, every bucket) summed."""
from perfbench.readers import per_step_ms

HOPS = ("rs_node", "ag_node")


def read(rec, ctx):
    got = [per_step_ms(rec, ctx, f"grad_sync/{h}") for h in HOPS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
