"""What several metric readers share."""
from __future__ import annotations


def per_step_ms(rec: dict, ctx, name: str):
    """Device ms a traced step of the operations launched inside the
    program's range ``name`` (rank 0), or None where the trace has none."""
    t = rec.get("trace")
    if t is None or ctx.device_type != "cuda" or name not in t["ranges"]:
        return None
    return 1e3 * t["ranges"][name] / rec["trace_steps"]


def kernel_rows(rec: dict, ctx, *marks: str) -> list:
    """The traced device operations whose names hold every one of
    ``marks``: [[name, launches, seconds], ...]."""
    t = rec.get("trace")
    if t is None or ctx.device_type != "cuda":
        return []
    return [r for r in t["kernels"] if all(m in r[0] for m in marks)]
