"""Host ms a planned second of ``cronsun.assign``'s own time (the bid and
waterfill rounds' launches): its spans less the ``cronsun.sync`` spans inside
them, recorded with no profiler running: the median over the run's
windows (:mod:`portbench.program_spans`)."""

from portbench import program_spans as ps


def read(ctx):
    return ps.median_per_second(
        ctx, ps.self_ms("cronsun.assign", "cronsun.sync"))
