"""k1_roofline_pct: K1's least time at the cell's shapes
(``roofline.flops.k1_bound_s``: causal, one launch a layer over this
rank's rows) over its device time per launch in the traced steps, in
percent.  The launches counted in the profile are held against the
attention layers times the steps; a difference is printed."""
import sys

from perfbench.readers import kernel_rows
from perfbench.roofline import flops


def read(rec, ctx):
    rows = kernel_rows(rec, ctx, "flash_attention")
    pk = flops.peaks(rec.get("device_kind", ""))
    if not rows or pk is None:
        return None
    dm = ctx.family.dims(ctx.config)
    launches = sum(r[1] for r in rows)
    want = dm["attn_layers"] * rec["trace_steps"]
    if launches != want:
        print(f"[perfbench] k1_roofline_pct: {launches} K1 launches in the "
              f"profile, want {want}", file=sys.stderr, flush=True)
    bound, _ = flops.k1_bound_s(pk, rec["rows"], dm["heads"], dm["kv_heads"],
                                rec["seq"], rec["seq"], dm["head_dim"],
                                causal=True)
    return 100.0 * bound / (sum(r[2] for r in rows) / launches)
