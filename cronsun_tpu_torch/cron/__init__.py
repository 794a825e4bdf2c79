"""Cron spec compiler (the port's own copy of ``cronsun_tpu.cron``'s parser).

Only the parser is carried over: the planner needs compiled masks, not the
scalar ``Schedule.next`` walk (that arrives with the batched next-fire port).
"""

from .goduration import DurationError, parse_duration_ns, parse_duration_seconds
from .parser import (
    CronSpec,
    EverySpec,
    ParseError,
    STAR_BIT,
    parse,
    parse_standard,
)

__all__ = [
    "CronSpec", "EverySpec", "ParseError", "STAR_BIT", "parse",
    "parse_standard", "DurationError", "parse_duration_ns",
    "parse_duration_seconds",
]
