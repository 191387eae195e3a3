"""train_tokens_per_s: every token that every rank trained in the steps
that ended inside the window, over the time from the window's start to
the end of its last step (host clock, each step ending with
``torch.cuda.synchronize()``)."""


def read(rec, ctx):
    w = rec.get("window")
    if not w or ctx.device_type != "cuda":
        return None
    return w["tokens"] / w["seconds"]
