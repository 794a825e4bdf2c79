"""Host-side calendar decomposition: epoch seconds -> cron field indices.

The device kernels test bitmask membership; *what* the wall-clock fields of a
given instant are is decided here on the host, once per window second.  This
is how the TPU path stays timezone- and DST-correct: the reference's cron loop
is TZ-aware (node/cron/cron.go:212-215 uses ``time.Now().In(loc)``), so the
host enumerates actual wall instants in the target zone — a DST spring-forward
gap simply never appears in the enumeration, and a fall-back fold appears
twice, exactly as real wall clocks do.

Two paths:

- fixed-offset zones (UTC or any constant offset): fully vectorized numpy
  civil-from-days math (Howard Hinnant's algorithm) — O(W) numpy ops, no
  Python per-instant loop; this is the hot path for the 1M-job tick bench.
- DST zones (zoneinfo): per-instant Python ``datetime`` loop; windows on the
  tick path are short (W <= a few hundred), so this stays off the critical
  budget.
"""

from __future__ import annotations

import datetime as _dt
from datetime import timezone, timedelta

import numpy as np

__all__ = ["window_fields", "decompose_utc", "tz_fixed_offset_seconds"]

_UTC = timezone.utc


_probe_cache: dict = {}


def tz_fixed_offset_seconds(tz) -> "int | None":
    """Return the zone's constant UTC offset in seconds, or None if the zone
    has transitions (DST or historical offset changes) we must honor."""
    if tz is _UTC or tz == _UTC:
        return 0
    if isinstance(tz, timezone):  # datetime.timezone is always fixed
        return int(tz.utcoffset(None).total_seconds())
    try:
        # probe result cached per zone object (ZoneInfo instances are
        # interned per key); unhashable custom tzinfo just re-probes
        return _probe_cache[tz]
    except KeyError:
        pass
    except TypeError:
        return _probe_tz(tz)
    off = _probe_tz(tz)
    _probe_cache[tz] = off
    return off


def _probe_tz(tz) -> "int | None":
    # zoneinfo / pytz style: probe DETERMINISTIC instants — twice a month
    # over 2020..2031 (288 probes, ~0.4 ms, cached per zone).  The
    # density matters: quarterly sampling misses short offset excursions
    # (Africa/Casablanca leaves +01 for ~1 month each Ramadan), and any
    # wall-clock-dependent probe would make the classification flip
    # day-to-day and diverge across multi-host mesh ranks (hostsync
    # requires bit-identical planner inputs per rank).  Residual
    # assumption (documented): a transition legislated for after 2031,
    # or one published into the tzdb mid-process, is not seen until the
    # probe range is extended / the process restarts.
    probes = [
        _dt.datetime(year, month, day, 12, tzinfo=_UTC)
        for year in range(2020, 2032)
        for month in range(1, 13)
        for day in (1, 15)
    ]
    offs = {p.astimezone(tz).utcoffset() for p in probes}
    if len(offs) == 1:
        return int(offs.pop().total_seconds())
    return None


def decompose_utc(epoch_s: np.ndarray, offset_s: int = 0):
    """Vectorized civil decomposition of epoch seconds (+ fixed offset).

    Returns (sec, min, hour, dom, month, dow) int32 arrays, dow Sunday==0
    (Go's time.Weekday numbering, node/cron/spec.go:41-46).
    """
    t = np.asarray(epoch_s, dtype=np.int64) + offset_s
    days, rem = np.divmod(t, 86400)
    hour, rem = np.divmod(rem, 3600)
    minute, sec = np.divmod(rem, 60)
    # 1970-01-01 was a Thursday; Sunday==0 indexing puts Thursday at 4.
    dow = (days + 4) % 7
    # Howard Hinnant civil_from_days, vectorized.
    z = days + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                                    # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)           # [0, 365]
    mp = (5 * doy + 2) // 153                                 # [0, 11]
    dom = doy - (153 * mp + 2) // 5 + 1                       # [1, 31]
    month = np.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    i32 = np.int32
    return (sec.astype(i32), minute.astype(i32), hour.astype(i32),
            dom.astype(i32), month.astype(i32), dow.astype(i32))


def window_fields(start_epoch_s: int, count: int, step_s: int = 1, tz=_UTC):
    """Field table for a window of ``count`` instants starting at
    ``start_epoch_s`` spaced ``step_s`` apart, decomposed in ``tz``.

    Returns a dict of numpy int32 arrays with keys
    ``sec/min/hour/dom/month/dow``, each shape [count].
    """
    off = tz_fixed_offset_seconds(tz)
    if off is not None:
        epochs = start_epoch_s + step_s * np.arange(count, dtype=np.int64)
        s, m, h, d, mo, w = decompose_utc(epochs, off)
    else:
        s = np.empty(count, np.int32); m = np.empty(count, np.int32)
        h = np.empty(count, np.int32); d = np.empty(count, np.int32)
        mo = np.empty(count, np.int32); w = np.empty(count, np.int32)
        t = _dt.datetime.fromtimestamp(start_epoch_s, _UTC)
        delta = timedelta(seconds=step_s)
        for i in range(count):
            loc = t.astimezone(tz)
            s[i] = loc.second; m[i] = loc.minute; h[i] = loc.hour
            d[i] = loc.day; mo[i] = loc.month; w[i] = (loc.weekday() + 1) % 7
            t += delta
    return {"sec": s, "min": m, "hour": h, "dom": d, "month": mo, "dow": w}
