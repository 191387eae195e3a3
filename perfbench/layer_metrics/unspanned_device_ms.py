"""unspanned_device_ms: the device time of a traced step (its
operations' durations summed, rank 0) less that of the program's
forward, backward, gradient-sync and optimizer ranges: device work the
step's named ranges miss.  Below zero, a range counted some operations
twice: ``trace.summarize``'s ranges take an operation once for each host
event it is linked to, and CUPTI's "Command Buffer Full" records (the
host blocked on a full launch queue, mostly in the optimizer) take the
blocked operation's kernels a second time.  Readings from before and
after ``trace.summarize`` counts each operation once are not
comparable: the fix lifts this metric to about 0.  A program without
the ``train_step`` range (whose backward lay outside its range) reads
nothing."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    if per_step_ms(rec, ctx, "train_step") is None:
        return None
    total = 1e3 * rec["trace"]["kernel_sum_s"] / rec["trace_steps"]
    for name in ("forward", "backward", "grad_sync", "optimizer"):
        total -= per_step_ms(rec, ctx, f"train_step/{name}") or 0.0
    return total
