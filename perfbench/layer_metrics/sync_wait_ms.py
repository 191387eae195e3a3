"""sync_wait_ms: the device time of the operations launched inside the
program's ``train_step/loss_mean`` range, a traced step (rank 0): the
loss's small all-reduce over the ranks, the first collective after the
backward.  It is a lower bound on rank 0's wait for the slowest rank,
not the wait: the rest of the wait lies in the sync's NCCL kernels
(``sync_node_ms``, ``sync_lane_ms``), each of which holds its peers'
lateness."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    return per_step_ms(rec, ctx, "train_step/loss_mean")
