"""The program's own spans (``cronsun_tpu_torch.ops.spans``) as the span
metrics of a planner cell read them.

The windows read are those of the newest planner the run built that were
gathered and planned with no profiler running (in a traced run: the
warm-up, the timed window and its drain, not the traced block).  A reader
reduces each window to a number, divides it by the window's seconds and
reports the median over the windows.  Nothing is read off the card (the
CPU runs the plain path, whose host time is the whole computation), nor
from a program that keeps no spans.
"""

from __future__ import annotations

import statistics

GATHER = "cronsun.plan.gather"


def windows(ctx):
    """[(seconds, spans)] of the windows read; empty when there are none."""
    if getattr(ctx, "device_kind", "cpu") == "cpu":
        return []
    try:
        from cronsun_tpu_torch.ops import spans
    except ImportError:
        return []
    rec = spans.newest()
    if rec is None:
        return []
    out = []
    for w in rec.windows():
        if w.profiled:
            continue
        sp = w.spans()
        if any(s.name == GATHER and s.end_ns for s in sp):
            out.append((w.seconds, sp))
    return out


def median_per_second(ctx, per_window):
    """The median over the windows read of ``per_window(spans)`` over the
    window's seconds, or None."""
    ws = windows(ctx)
    if not ws:
        return None
    return statistics.median(per_window(sp) / seconds for seconds, sp in ws)


def ms_in(name):
    """Per window: ms in spans ``name``."""
    return lambda sp: sum(s.end_ns - s.start_ns
                          for s in sp if s.name == name) * 1e-6


def count_of(name):
    """Per window: the spans ``name``."""
    return lambda sp: sum(1 for s in sp if s.name == name)


def self_ms(name, minus):
    """Per window: ms in spans ``name`` less the ms of the spans ``minus``
    inside them (at any depth)."""
    def f(sp):
        inside = [False] * len(sp)
        total = 0
        for i, s in enumerate(sp):
            up = s.parent >= 0 and inside[s.parent]
            if s.name == name and not up:
                total += s.end_ns - s.start_ns
            elif s.name == minus and up:
                total -= s.end_ns - s.start_ns
            inside[i] = up or s.name == name
        return total * 1e-6
    return f
