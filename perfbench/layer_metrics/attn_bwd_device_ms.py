"""attn_bwd_device_ms: the device time of the operations launched inside
the program's ``attention_backward`` ranges (K1's backward, in every
attention layer), a traced step (rank 0)."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    return per_step_ms(rec, ctx, "attention_backward")
