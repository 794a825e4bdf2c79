"""K1's share of its roofline, in %: the least time its first-round
launches need at the card's HBM peak (the byte model of
:mod:`portbench.roofline`, each active row's words read once) over their
time on the device, in the traced block.  Each planned second launches K1
once a bid round, in order, so the first of each second's launches is the
round in which every fired exclusive row is active; a later round's active
rows depend on the first round's accepts, which no output shows.  Nothing
is read when the block holds another number of launches."""

from portbench import roofline


def read(ctx):
    tr = getattr(ctx, "trace", None)
    peak = roofline.peak_bytes_s(getattr(ctx, "device_kind", ""))
    if tr is None or peak is None or not getattr(ctx, "traced", None):
        return None
    ops = [o for o in tr.ops_named("bid_argmin") if "natural" not in o[0]]
    r = ctx.rounds
    if len(ops) != r * len(ctx.traced):
        return None
    kx = ctx.bucket[0]
    n_bytes = sum(roofline.k1_bytes(nx, kx, ctx.w32) for nx, _nc in ctx.traced)
    t = sum(dur for _n, _ts, dur in ops[::r]) * 1e-6
    if not t or not any(nx for nx, _nc in ctx.traced):
        return None
    return n_bytes / peak / t * 100.0
