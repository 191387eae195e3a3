"""step_mfu: the model FLOPs of the traced steps
(``roofline.flops.train_step_flops``) over the traced window's seconds x
chips x the card's dense bf16 peak, in percent: the whole step's share
of the peak, which bounds what any one kernel's roofline share can
give ``train_mfu``."""
from perfbench.roofline import flops


def read(rec, ctx):
    t = rec.get("trace")
    pk = flops.peaks(rec.get("device_kind", ""))
    if t is None or pk is None or ctx.device_type != "cuda":
        return None
    step = flops.train_step_flops(ctx.family.dims(ctx.config),
                                  rec["rows_global"], rec["seq"])
    return 100.0 * step * rec["trace_steps"] / (
        t["window_s"] * ctx.world * pk["bf16_flop_per_s"])
