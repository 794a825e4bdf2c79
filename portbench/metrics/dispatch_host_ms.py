"""Host ms a planned second inside the planner's ``cronsun.plan.dispatch``
range (issuing a window) in the traced block."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if tr is None or not getattr(ctx, "traced_seconds", 0):
        return None
    s = tr.host_s_of("cronsun.plan.dispatch")
    return s * 1e3 / ctx.traced_seconds if s else None
