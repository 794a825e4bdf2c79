"""Host ms a planned second in the program's ``cronsun.plan.gather.wait``
spans (a gather waiting for its window to land: near 0 while the host sets
the pace), recorded with no profiler running: the median over the run's
windows (:mod:`portbench.program_spans`)."""

from portbench import program_spans as ps


def read(ctx):
    return ps.median_per_second(ctx, ps.ms_in("cronsun.plan.gather.wait"))
