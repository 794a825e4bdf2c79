"""Scalar schedule evaluation: the correctness anchor for the TPU kernels.

Re-implements the reference's field-walking ``Next`` algorithm
(reference: node/cron/spec.go:55-145) on Python aware-datetimes, matching its
semantics exactly:

- start the search at the next whole second strictly after ``t``;
- walk month -> day -> hour -> minute -> second, incrementing a field until it
  matches and resetting lower fields on the first increment;
- wrap-around on any field restarts the walk (preserving the "already
  incremented" flag);
- give up after a five-year scan (unsatisfiable specs return ``None`` —
  the reference's zero time);
- day matching ORs day-of-month and day-of-week when **both** are restricted,
  ANDs them when either is a star (node/cron/spec.go:149-158);
- all fixed-duration adds are *absolute* (instant) arithmetic, all field
  resets are *wall-clock* constructions — this reproduces the reference's
  daylight-saving behavior, because Go's ``Time.Add`` is absolute while
  ``time.Date`` is a wall-clock constructor.

The port's own copy (of ``cronsun_tpu/cron/schedule.py``): the batched
``next_fire`` (``ops/tick.py``) re-walks DST-transition days with it.
"""

from __future__ import annotations

import datetime as _dt
from datetime import timedelta, timezone
from typing import Optional

from .parser import CronSpec, EverySpec

_UTC = timezone.utc


def _abs_add(t: _dt.datetime, delta: timedelta) -> _dt.datetime:
    """Absolute (instant) addition, like Go's Time.Add."""
    return (t.astimezone(_UTC) + delta).astimezone(t.tzinfo)


def _wall(year: int, month: int, day: int, hour: int, minute: int, second: int,
          tz) -> _dt.datetime:
    """Wall-clock construction, like Go's time.Date: normalizes day overflow
    and resolves DST gaps/folds to a real instant."""
    # Normalize day overflow (e.g. Jan 31 + 1 month -> Mar 3) via date math.
    months_extra, month0 = divmod(month - 1, 12)
    year += months_extra
    base = _dt.date(year, month0 + 1, 1) + timedelta(days=day - 1)
    naive = _dt.datetime(base.year, base.month, base.day, hour, minute, second,
                         tzinfo=tz, fold=0)
    # Round-trip through UTC so a nonexistent wall time (DST spring gap)
    # normalizes to the real instant, and fields reflect the actual offset.
    return naive.astimezone(_UTC).astimezone(tz)


def _weekday_sun0(t: _dt.datetime) -> int:
    """Day of week with Sunday == 0 (Go's time.Weekday)."""
    return (t.weekday() + 1) % 7


def day_matches(spec: CronSpec, dom: int, dow: int) -> bool:
    """The reference's dayMatches rule (node/cron/spec.go:149-158)."""
    dom_ok = bool((1 << dom) & spec.dom)
    dow_ok = bool((1 << dow) & spec.dow)
    if spec.dom_star or spec.dow_star:
        return dom_ok and dow_ok
    return dom_ok or dow_ok


def next_after(spec: CronSpec, t: _dt.datetime) -> Optional[_dt.datetime]:
    """Next activation strictly after ``t``, or None if unsatisfiable
    within five years.  ``t`` must be timezone-aware."""
    tz = t.tzinfo
    if tz is None:
        raise ValueError("next_after requires an aware datetime")

    # Advance to the next whole second (strictly greater than t).
    t = _abs_add(t, timedelta(seconds=1) - timedelta(microseconds=t.microsecond))

    added = False
    year_limit = t.year + 5

    while True:  # WRAP
        if t.year > year_limit:
            return None

        # Month.
        wrapped = False
        while not ((1 << t.month) & spec.month):
            if not added:
                added = True
                t = _wall(t.year, t.month, 1, 0, 0, 0, tz)
            t = _wall(t.year, t.month + 1, t.day, t.hour, t.minute, t.second, tz)
            if t.month == 1:
                wrapped = True
                break
        if wrapped:
            continue

        # Day.
        wrapped = False
        while not day_matches(spec, t.day, _weekday_sun0(t)):
            if not added:
                added = True
                t = _wall(t.year, t.month, t.day, 0, 0, 0, tz)
            t = _wall(t.year, t.month, t.day + 1, t.hour, t.minute, t.second, tz)
            if t.day == 1:
                wrapped = True
                break
        if wrapped:
            continue

        # Hour (absolute adds: DST-faithful).
        wrapped = False
        while not ((1 << t.hour) & spec.hour):
            if not added:
                added = True
                t = _wall(t.year, t.month, t.day, t.hour, 0, 0, tz)
            t = _abs_add(t, timedelta(hours=1))
            if t.hour == 0:
                wrapped = True
                break
        if wrapped:
            continue

        # Minute.
        wrapped = False
        while not ((1 << t.minute) & spec.minute):
            if not added:
                added = True
                t = t.replace(second=0, microsecond=0)
            t = _abs_add(t, timedelta(minutes=1))
            if t.minute == 0:
                wrapped = True
                break
        if wrapped:
            continue

        # Second.
        wrapped = False
        while not ((1 << t.second) & spec.second):
            if not added:
                added = True
                t = t.replace(microsecond=0)
            t = _abs_add(t, timedelta(seconds=1))
            if t.second == 0:
                wrapped = True
                break
        if wrapped:
            continue

        return t


def every_next_after(spec: EverySpec, t: _dt.datetime) -> _dt.datetime:
    """ConstantDelay.Next: t + period, truncated to the second
    (reference: node/cron/constantdelay.go:23-27)."""
    if t.tzinfo is None:
        raise ValueError("every_next_after requires an aware datetime")
    return _abs_add(t, timedelta(seconds=spec.period_s)
                    - timedelta(microseconds=t.microsecond))


class Schedule:
    """Uniform wrapper over CronSpec/EverySpec with a ``next(t)`` method —
    the seam the reference exposes as the cron.Schedule interface
    (node/cron/cron.go:36-40)."""

    def __init__(self, spec):
        self.spec = spec

    def next(self, t: _dt.datetime) -> Optional[_dt.datetime]:
        if isinstance(self.spec, EverySpec):
            return every_next_after(self.spec, t)
        return next_after(self.spec, t)
