"""bwd_device_ms: the device time of a traced step (its operations'
durations summed, rank 0) less that of the forward, optimizer and
gradient-sync ranges.  The backward's operations run on autograd's own
thread, outside the host's ``train_step/backward`` range, so the range
itself cannot be read."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    t = rec.get("trace")
    if t is None or ctx.device_type != "cuda":
        return None
    total = 1e3 * t["kernel_sum_s"] / rec["trace_steps"]
    for name in ("forward", "optimizer", "grad_sync"):
        total -= per_step_ms(rec, ctx, f"train_step/{name}") or 0.0
    return total
