"""ssd_bwd_device_ms: the device time of the operations launched inside
the program's ``ssd_backward`` ranges (K2's backward, in every SSD
layer), a traced step (rank 0)."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    return per_step_ms(rec, ctx, "ssd_backward")
