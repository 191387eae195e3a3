"""moe_drop_pct: the share of the MoE's (token, expert) assignments that
capacity dropped in the traced steps, in percent: 100 (assigned - kept)
/ assigned, from the program's counters ``moe.assigned`` and
``moe.kept`` (``repro_torch.obs.counters()`` in rank 0's process; they
count only while the profiler records).  The guard of ``moe_device_ms``:
a block made faster by dropping more assignments is not a gain.  A
program without the counters reads nothing."""


def read(rec, ctx):
    if rec.get("trace") is None or ctx.device_type != "cuda":
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    got = obs.counters()
    assigned = got.get("moe.assigned", 0)
    if not assigned:
        return None
    return 100.0 * (assigned - got.get("moe.kept", 0)) / assigned
