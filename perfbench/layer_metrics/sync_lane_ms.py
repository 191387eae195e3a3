"""sync_lane_ms: the device time of the gradient sync's lane hop, a
traced step (rank 0): the program's ``grad_sync/ar_lane`` range (the
all-reduce across the lane group, every bucket), summed with the lane
stages of the other bucketed syncs where they ran (``ar_lane_int8``,
``ar_lane_quorum``, ``rs_lane``)."""
from perfbench.readers import per_step_ms

HOPS = ("ar_lane", "ar_lane_int8", "ar_lane_quorum", "rs_lane")


def read(rec, ctx):
    got = [per_step_ms(rec, ctx, f"grad_sync/{h}") for h in HOPS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
