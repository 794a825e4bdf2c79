"""Host ms a planned second in the program's ``cronsun.sync`` spans (the
calls on the dispatch path that wait for the stream), recorded with no
profiler running: the median over the run's windows
(:mod:`portbench.program_spans`)."""

from portbench import program_spans as ps


def read(ctx):
    return ps.median_per_second(ctx, ps.ms_in("cronsun.sync"))
