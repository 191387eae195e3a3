"""setup_s: from the process's start to the window's start: imports,
loading (or, in a checkout's first run, building) the kernels, the
weights and optimizer state made on the card, the rows, and the checked
steps that also warm every shape up."""


def read(rec, ctx):
    if "window_start" not in rec or ctx.device_type != "cuda":
        return None
    return rec["window_start"] - ctx.t_start
