"""K2's share of its roofline, in %: the least time its launches need at
the card's HBM peak (the byte model of :mod:`portbench.roofline`, each
weighted row's words read once) over their time on the device, in the
traced block (one launch a planned second)."""

from portbench import roofline


def read(ctx):
    tr = getattr(ctx, "trace", None)
    peak = roofline.peak_bytes_s(getattr(ctx, "device_kind", ""))
    if tr is None or peak is None or not getattr(ctx, "traced", None):
        return None
    ops = tr.ops_named("fanout_add")
    if len(ops) != len(ctx.traced):
        return None
    kc = ctx.bucket[1]
    n_bytes = sum(roofline.k2_bytes(nc, kc, ctx.w32) for _nx, nc in ctx.traced)
    t = sum(dur for _n, _ts, dur in ops) * 1e-6
    if not t or not any(nc for _nx, nc in ctx.traced):
        return None
    return n_bytes / peak / t * 100.0
