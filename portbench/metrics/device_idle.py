"""The device's idle share of the traced block, in %: one minus the time
in which a device operation ran, over the block's length."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if tr is None or tr.window_s() <= 0 or not tr.window_ops():
        return None
    return (1.0 - tr.busy_s() / tr.window_s()) * 100.0
