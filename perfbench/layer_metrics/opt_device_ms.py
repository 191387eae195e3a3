"""opt_device_ms: the device time of the operations launched inside the
program's ``train_step/optimizer`` range, a traced step (rank 0)."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    return per_step_ms(rec, ctx, "train_step/optimizer")
