"""Exclusive fires left unplaced a planned second (every eligible node
full, or the last bid refused by a node that filled): the program's
``cronsun.unplaced`` counter (``Window.counts`` of
``cronsun_tpu_torch.ops.spans``, counted by a window's gather from the
output it copied) over the window's seconds, the median over the windows
:mod:`portbench.program_spans` reads (gathered, planned with no profiler
running, on the card).  Nothing is read from a program whose windows keep
no counters."""

import statistics

from portbench import program_spans as ps

COUNTER = "cronsun.unplaced"


def read(ctx):
    if getattr(ctx, "device_kind", "cpu") == "cpu":
        return None
    try:
        from cronsun_tpu_torch.ops import spans
    except ImportError:
        return None
    rec = spans.newest()
    if rec is None:
        return None
    vals = []
    for w in rec.windows():
        counts = getattr(w, "counts", None)
        if counts is None:          # a program without counters
            return None
        if w.profiled or not any(s.name == ps.GATHER and s.end_ns
                                 for s in w.spans()):
            continue
        vals.append(counts.get(COUNTER, 0) / w.seconds)
    return statistics.median(vals) if vals else None
