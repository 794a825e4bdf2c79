"""Go-compatible duration string parsing.

The reference accepts ``@every <duration>`` where the duration uses Go's
``time.ParseDuration`` grammar (reference: node/cron/parser.go:367-374).
This module re-implements that grammar in Python so configs written for the
reference parse identically: a signed sequence of decimal numbers, each with
an optional fraction and a mandatory unit suffix, e.g. ``300ms``, ``1.5h``,
``2h45m``. Valid units: ``ns``, ``us`` (or ``µs``/``μs``), ``ms``, ``s``,
``m``, ``h``.
"""

from __future__ import annotations

_UNITS_NS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,  # µs
    "μs": 1_000,  # μs
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}


_UNITS_ORDERED = tuple(sorted(_UNITS_NS, key=len, reverse=True))


class DurationError(ValueError):
    pass


def parse_duration_ns(s: str) -> int:
    """Parse a Go duration string, returning nanoseconds (may be negative)."""
    orig = s
    neg = False
    if s and s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0
    if not s:
        raise DurationError(f"invalid duration: {orig!r}")
    total = 0
    while s:
        # integer part
        i = 0
        while i < len(s) and s[i].isdigit():
            i += 1
        int_part = s[:i]
        s = s[i:]
        frac_part = ""
        if s.startswith("."):
            s = s[1:]
            i = 0
            while i < len(s) and s[i].isdigit():
                i += 1
            frac_part = s[:i]
            s = s[i:]
        if not int_part and not frac_part:
            raise DurationError(f"invalid duration: {orig!r}")
        # unit: longest match first (two-char units before one-char)
        unit = None
        for u in _UNITS_ORDERED:
            if s.startswith(u):
                unit = u
                break
        if unit is None:
            raise DurationError(f"missing or unknown unit in duration: {orig!r}")
        s = s[len(unit):]
        scale = _UNITS_NS[unit]
        value = int(int_part or "0") * scale
        if frac_part:
            value += int(round(float("0." + frac_part) * scale))
        total += value
    return -total if neg else total


def parse_duration_seconds(s: str) -> float:
    """Parse a Go duration string, returning seconds as float."""
    return parse_duration_ns(s) / 1e9
