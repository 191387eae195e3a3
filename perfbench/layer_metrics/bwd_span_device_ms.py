"""bwd_span_device_ms: the device time of the operations launched inside
the program's ``train_step/backward`` range, a traced step (rank 0).  The
backward's own first node opens the range and the engine's final
callback closes it, on the thread that runs the backward (autograd's
device thread), so the range holds the backward's kernels.  A program
without the ``train_step`` range, whose backward ran on autograd's own
thread outside its range, reads nothing."""
from perfbench.readers import per_step_ms


def read(rec, ctx):
    if per_step_ms(rec, ctx, "train_step") is None:
        return None
    return per_step_ms(rec, ctx, "train_step/backward")
