"""Fires planned and placed in the timed window (exclusive placements and
Common fires of every window gathered in it) over its wall time."""


def read(ctx):
    if getattr(ctx, "placed_fires", None) is None:
        return None
    return ctx.placed_fires / ctx.window_wall_s
