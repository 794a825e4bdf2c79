"""The 99th percentile, over every window completed in the timed window,
of its completion interval (host clock, gather to gather) over the
seconds it planned: ms a planned second."""

import numpy as np


def read(ctx):
    iv = getattr(ctx, "intervals_s", None)
    if iv is None or not len(iv):
        return None
    return float(np.percentile(iv, 99)) / ctx.W * 1e3
