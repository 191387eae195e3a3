"""k2_roofline_pct: K2's least time at the cell's shapes
(``roofline.flops.k2_bound_s``: one scan a layer over this rank's rows,
from a zero state) over its device time per call in the traced steps
(its three bf16 kernels summed), in percent.  The calls counted (the
output kernel's launches) are held against the SSD layers times the
steps; a difference is printed."""
import sys

from perfbench.readers import kernel_rows
from perfbench.roofline import flops


def read(rec, ctx):
    rows = kernel_rows(rec, ctx, "ssd_", "_kernel")
    calls = sum(r[1] for r in rows if "ssd_output_kernel" in r[0])
    pk = flops.peaks(rec.get("device_kind", ""))
    if not rows or not calls or pk is None:
        return None
    dm = ctx.family.dims(ctx.config)
    want = dm["ssd_layers"] * rec["trace_steps"]
    if calls != want:
        print(f"[perfbench] k2_roofline_pct: {calls} K2 calls in the "
              f"profile, want {want}", file=sys.stderr, flush=True)
    bound, _ = flops.k2_bound_s(pk, rec["rows"], dm["ssd_heads"], rec["seq"],
                                dm["ssd_head_dim"], dm["ssd_state"],
                                dm["ssd_chunk"])
    return 100.0 * bound / (sum(r[2] for r in rows) / calls)
