"""Stream waits a planned second: the program's ``cronsun.sync`` spans
(one a wait) over the window's seconds, the median over the run's windows
planned with no profiler running (:mod:`portbench.program_spans`): a count
that repeats exactly."""

from portbench import program_spans as ps


def read(ctx):
    return ps.median_per_second(ctx, ps.count_of("cronsun.sync"))
