"""Device operations (kernels, copies, memsets) a planned second in the
traced block: a count that repeats exactly."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if tr is None or not getattr(ctx, "traced_seconds", 0):
        return None
    n = len(tr.window_ops())
    return n / ctx.traced_seconds if n else None
