"""Cron spec compiler: text spec -> bitmask schedule.

Grammar-compatible with the reference's vendored robfig/cron fork
(reference: node/cron/parser.go:78-377, node/cron/spec.go:18-51):

- Six second-granularity fields ``sec min hour dom month dow`` with the
  day-of-week field optional (``parse``), or the standard five-field crontab
  (``parse_standard``).
- Each field is a comma-separated list of ranges; a range is ``*``/``?``,
  ``N``, ``N-M``, optionally followed by ``/step``.  ``N/step`` means
  ``N-max/step``.
- Month and day-of-week names (``jan``..``dec``, ``sun``..``sat``),
  case-insensitive.
- Descriptors ``@yearly``/``@annually``, ``@monthly``, ``@weekly``,
  ``@daily``/``@midnight``, ``@hourly`` and ``@every <go-duration>``.

A compiled :class:`CronSpec` stores one bitmask per field (as a Python int
with uint64 semantics).  Bit 63 (``STAR_BIT``) marks a field written as
``*``/``?`` — the day-of-month vs day-of-week matching rule depends on it.
The masks are the on-ramp for the TPU path: a batch of specs is a dense
``[J, 6]`` mask table (see cronsun_tpu.ops.schedule_table).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .goduration import DurationError, parse_duration_ns

STAR_BIT = 1 << 63
_U64 = (1 << 64) - 1


class ParseError(ValueError):
    pass


@dataclass(frozen=True)
class _Bounds:
    min: int
    max: int
    names: Optional[dict] = None


SECONDS = _Bounds(0, 59)
MINUTES = _Bounds(0, 59)
HOURS = _Bounds(0, 23)
DOM = _Bounds(1, 31)
MONTHS = _Bounds(1, 12, {
    "jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
    "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12,
})
DOW = _Bounds(0, 6, {
    "sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6,
})

_FIELD_BOUNDS = (SECONDS, MINUTES, HOURS, DOM, MONTHS, DOW)
_FIELD_DEFAULTS = ("0", "0", "0", "*", "*", "*")


@dataclass(frozen=True)
class CronSpec:
    """A compiled cron schedule: six uint64 bitmasks (+ star bits)."""

    second: int
    minute: int
    hour: int
    dom: int
    month: int
    dow: int

    @property
    def dom_star(self) -> bool:
        return bool(self.dom & STAR_BIT)

    @property
    def dow_star(self) -> bool:
        return bool(self.dow & STAR_BIT)

    def masks(self) -> tuple:
        return (self.second, self.minute, self.hour, self.dom, self.month, self.dow)


@dataclass(frozen=True)
class EverySpec:
    """``@every <duration>`` schedule: a constant delay, floored to >= 1s and
    truncated to whole seconds (reference: node/cron/constantdelay.go:14-21)."""

    period_s: int

    @staticmethod
    def from_duration_ns(ns: int) -> "EverySpec":
        # Floor to 1s, truncate to whole seconds — integer math, no float
        # round-trip (reference: node/cron/constantdelay.go:14-21).
        period = ns // 1_000_000_000
        return EverySpec(period_s=max(1, int(period)))


def _bits(lo: int, hi: int, step: int) -> int:
    if step == 1:
        return (~(_U64 << (hi + 1)) & (_U64 << lo)) & _U64
    out = 0
    for i in range(lo, hi + 1, step):
        out |= 1 << i
    return out


def _all_bits(b: _Bounds) -> int:
    return _bits(b.min, b.max, 1) | STAR_BIT


def _parse_int_or_name(expr: str, b: _Bounds) -> int:
    if b.names is not None:
        v = b.names.get(expr.lower())
        if v is not None:
            return v
    if expr.startswith("-"):
        raise ParseError(f"negative number not allowed: {expr!r}")
    digits = expr[1:] if expr.startswith("+") else expr
    if not digits.isascii() or not digits.isdigit():
        raise ParseError(f"failed to parse int from {expr!r}")
    return int(digits, 10)


def _parse_range(expr: str, b: _Bounds) -> int:
    range_and_step = expr.split("/")
    if len(range_and_step) > 2:
        raise ParseError(f"too many slashes: {expr!r}")
    low_and_high = range_and_step[0].split("-")
    single = len(low_and_high) == 1

    extra = 0
    if low_and_high[0] in ("*", "?"):
        start, end = b.min, b.max
        extra = STAR_BIT
    else:
        start = _parse_int_or_name(low_and_high[0], b)
        if len(low_and_high) == 1:
            end = start
        elif len(low_and_high) == 2:
            end = _parse_int_or_name(low_and_high[1], b)
        else:
            raise ParseError(f"too many hyphens: {expr!r}")

    if len(range_and_step) == 1:
        step = 1
    else:
        step_s = range_and_step[1]
        if not step_s.isascii() or not step_s.isdigit():
            raise ParseError(f"failed to parse step from {expr!r}")
        step = int(step_s, 10)
        if single:
            # "N/step" means "N-max/step"
            end = b.max

    if start < b.min:
        raise ParseError(f"beginning of range ({start}) below minimum ({b.min}): {expr!r}")
    if end > b.max:
        raise ParseError(f"end of range ({end}) above maximum ({b.max}): {expr!r}")
    if start > end:
        raise ParseError(f"beginning of range ({start}) beyond end of range ({end}): {expr!r}")
    if step == 0:
        raise ParseError(f"step of range should be a positive number: {expr!r}")

    return _bits(start, end, step) | extra


def _parse_field(field: str, b: _Bounds) -> int:
    bits = 0
    for expr in field.split(","):
        if expr == "":
            continue
        bits |= _parse_range(expr, b)
    return bits


_DESCRIPTORS = {
    # name -> (sec, min, hour, dom, month, dow) mask factory
    "@yearly": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, 1 << 1, 1 << 1, _all_bits(DOW)),
    "@annually": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, 1 << 1, 1 << 1, _all_bits(DOW)),
    "@monthly": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, 1 << 1, _all_bits(MONTHS), _all_bits(DOW)),
    "@weekly": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, _all_bits(DOM), _all_bits(MONTHS), 1 << 0),
    "@daily": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, _all_bits(DOM), _all_bits(MONTHS), _all_bits(DOW)),
    "@midnight": lambda: CronSpec(1 << 0, 1 << 0, 1 << 0, _all_bits(DOM), _all_bits(MONTHS), _all_bits(DOW)),
    "@hourly": lambda: CronSpec(1 << 0, 1 << 0, _all_bits(HOURS), _all_bits(DOM), _all_bits(MONTHS), _all_bits(DOW)),
}


def _parse_descriptor(spec: str):
    factory = _DESCRIPTORS.get(spec)
    if factory is not None:
        return factory()
    if spec.startswith("@every "):
        try:
            ns = parse_duration_ns(spec[len("@every "):])
        except DurationError as e:
            raise ParseError(f"failed to parse duration {spec!r}: {e}")
        return EverySpec.from_duration_ns(ns)
    raise ParseError(f"unrecognized descriptor: {spec!r}")


def _parse_fields(fields: list, n_min: int, n_max: int, spec: str):
    if not (n_min <= len(fields) <= n_max):
        if n_min == n_max:
            raise ParseError(f"expected exactly {n_min} fields, found {len(fields)}: {spec!r}")
        raise ParseError(f"expected {n_min} to {n_max} fields, found {len(fields)}: {spec!r}")


def parse(spec: str):
    """Parse a 6-field second-granularity spec (dow optional) or descriptor.

    Mirrors the reference's default parser (node/cron/parser.go:171-183).
    Returns a :class:`CronSpec` or :class:`EverySpec`.
    """
    if not spec:
        raise ParseError("empty spec")
    if spec[0] == "@":
        return _parse_descriptor(spec)
    fields = spec.split()
    _parse_fields(fields, 5, 6, spec)
    if len(fields) == 5:
        fields = fields + ["*"]
    masks = [_parse_field(f, b) for f, b in zip(fields, _FIELD_BOUNDS)]
    return CronSpec(*masks)


def parse_standard(spec: str):
    """Parse a standard 5-field crontab spec (min hour dom month dow) or
    descriptor.  Mirrors ParseStandard (node/cron/parser.go:155-169)."""
    if not spec:
        raise ParseError("empty spec")
    if spec[0] == "@":
        return _parse_descriptor(spec)
    fields = spec.split()
    _parse_fields(fields, 5, 5, spec)
    fields = ["0"] + fields  # seconds default 0
    masks = [_parse_field(f, b) for f, b in zip(fields, _FIELD_BOUNDS)]
    return CronSpec(*masks)
