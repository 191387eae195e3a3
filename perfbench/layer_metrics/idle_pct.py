"""idle_pct: the share of the traced window (rank 0) in which no
operation ran on the device, in percent."""


def read(rec, ctx):
    t = rec.get("trace")
    if t is None or ctx.device_type != "cuda" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
