"""Device ms a planned second of the operations launched inside the
``cronsun.release`` range: the bulk releases' uploads, their element-wise
updates and the Common retirement's fan-out (K2), in the traced block."""

RANGE = "cronsun.release"


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if tr is None or not getattr(ctx, "traced_seconds", 0):
        return None
    s = tr.device_s_in(RANGE)
    return s * 1e3 / ctx.traced_seconds if s else None
