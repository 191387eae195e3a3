"""train_mfu: the model FLOPs of the window's tokens
(``roofline.flops.train_step_flops``: 6 per active product parameter and
token, plus 3x the attention's and the SSD scan's forward) over window
seconds x chips x the card's dense bf16 peak, in percent."""
from perfbench.roofline import flops


def read(rec, ctx):
    w = rec.get("window")
    pk = flops.peaks(rec["device_kind"])
    if not w or pk is None or ctx.device_type != "cuda":
        return None
    step = flops.train_step_flops(ctx.family.dims(ctx.config),
                                  rec["rows_global"], rec["seq"])
    return 100.0 * step * w["steps"] / (
        w["seconds"] * ctx.world * pk["bf16_flop_per_s"])
