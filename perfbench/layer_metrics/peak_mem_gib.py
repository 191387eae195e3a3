"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the traced
steps, after ``reset_peak_memory_stats()`` at their start (rank 0)."""


def read(rec, ctx):
    if rec.get("trace") is None or ctx.device_type != "cuda":
        return None
    return rec["peak_bytes_own"] / 2**30
