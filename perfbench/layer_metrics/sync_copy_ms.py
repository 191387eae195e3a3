"""sync_copy_ms: the device time of the gradient sync's copies, a traced
step (rank 0): the program's ``grad_sync/flatten`` range (the gradient
leaves cast into one flat f32 buffer) and ``grad_sync/unflatten`` range
(the mean's divide and the copy back into the leaves) summed."""
from perfbench.readers import per_step_ms

PARTS = ("flatten", "unflatten")


def read(rec, ctx):
    got = [per_step_ms(rec, ctx, f"grad_sync/{p}") for p in PARTS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
