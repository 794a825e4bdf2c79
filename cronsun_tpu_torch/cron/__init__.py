"""Cron spec compiler and scalar schedule evaluation (the port's own copies
of ``cronsun_tpu.cron``'s parser and ``Schedule``)."""

from .goduration import DurationError, parse_duration_ns, parse_duration_seconds
from .parser import (
    CronSpec,
    EverySpec,
    ParseError,
    STAR_BIT,
    parse,
    parse_standard,
)
from .schedule import (
    Schedule,
    day_matches,
    every_next_after,
    next_after,
)

__all__ = [
    "CronSpec", "EverySpec", "ParseError", "STAR_BIT", "parse",
    "parse_standard", "Schedule", "day_matches", "every_next_after",
    "next_after", "DurationError", "parse_duration_ns",
    "parse_duration_seconds",
]
