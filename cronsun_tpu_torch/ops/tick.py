"""Windowed fire-mask evaluation and batched next-fire (counterpart of
``cronsun_tpu/ops/tick.py``).

- :func:`fire_mask` — [J, W] bool: which rows fire at which window second.
  Six bitmask membership tests, the DOM/DOW star rule and the ``@every``
  modular test in one elementwise program over the whole table.  The
  calendar fields of each second are decided on the host (:mod:`.timecal`),
  which keeps the device program timezone- and DST-agnostic.
- :func:`next_fire` — batched ``Schedule.Next`` for every row at once:
  ``@every`` rows in closed form; cron rows by a second-granularity scan of
  the partial first minute, a minute-granularity scan through the end of
  tomorrow, and a day-granularity scan over the five-year horizon, in one
  pass per block of rows.  Rows the day scan resolved onto a DST-transition
  day are re-walked on the host with the scalar :class:`Schedule`.

Mask columns are int32 bit patterns (see :mod:`.schedule_table`); the shift
amounts are clamped to 0..31, so ``(x >> s) & 1`` reads bit ``s`` whether
the 32 bits are read as signed or unsigned.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from datetime import timezone
from typing import Optional

import numpy as np
import torch

from .schedule_table import FRAMEWORK_EPOCH, ScheduleTable
from .timecal import decompose_utc, tz_fixed_offset_seconds, window_fields

_UTC = timezone.utc


def _bit60(lo: torch.Tensor, hi: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Test bit ``idx`` (0..59) of a (lo, hi) 32-bit pair: [J] x [W] -> [J, W]."""
    idx = idx[None, :]
    lo_sh = idx.clamp(max=31)
    hi_sh = (idx - 32).clamp(0, 31)
    lo_bit = (lo[:, None] >> lo_sh) & 1
    hi_bit = (hi[:, None] >> hi_sh) & 1
    return torch.where(idx < 32, lo_bit, hi_bit) != 0


def _bit32(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Test bit ``idx`` (0..31) of a 32-bit mask: [J] x [W] -> [J, W] bool."""
    sh = idx[None, :].clamp(max=31)
    return ((mask[:, None] >> sh) & 1) != 0


def _day_ok(t: ScheduleTable, dom_idx: torch.Tensor,
            dow_idx: torch.Tensor) -> torch.Tensor:
    """DOM/DOW star semantics (node/cron/spec.go:149-158)."""
    dom_ok = _bit32(t.dom, dom_idx)
    dow_ok = _bit32(t.dow, dow_idx)
    either_star = (t.dom_star | t.dow_star)[:, None]
    return torch.where(either_star, dom_ok & dow_ok, dom_ok | dow_ok)


def _every_rem(t: ScheduleTable, t_rel: torch.Tensor) -> torch.Tensor:
    """Seconds until the next @every fire at each instant: [J, W] int32
    (0 means "fires exactly at this instant").  ``torch.remainder`` takes
    the divisor's sign, as ``jnp.mod`` does."""
    return torch.remainder(t.phase_mod[:, None] - t_rel[None, :],
                           t.period[:, None])


def _fire_mask(t: ScheduleTable, sec, mnt, hour, dom, month, dow,
               t_rel) -> torch.Tensor:
    """[J, W] bool from per-second int32 field vectors on ``t``'s device."""
    cron_ok = (
        _bit60(t.sec_lo, t.sec_hi, sec)
        & _bit60(t.min_lo, t.min_hi, mnt)
        & _bit32(t.hour, hour)
        & _day_ok(t, dom, dow)
        & _bit32(t.month, month)
    )
    every_ok = _every_rem(t, t_rel) == 0
    live = (t.active & ~t.paused)[:, None]
    return live & torch.where(t.is_every[:, None], every_ok, cron_ok)


def window_field_matrix(start_epoch_s: int, window_s: int, tz=_UTC) -> np.ndarray:
    """[W, 7] int32 host matrix: (sec, min, hour, dom, month, dow, t_rel)
    for each second of the window, ``t_rel`` relative to FRAMEWORK_EPOCH."""
    f = window_fields(start_epoch_s, window_s, step_s=1, tz=tz)
    return np.stack([
        f["sec"], f["min"], f["hour"], f["dom"], f["month"], f["dow"],
        np.arange(window_s, dtype=np.int64) + (start_epoch_s - FRAMEWORK_EPOCH),
    ], axis=1).astype(np.int32)


def fire_mask(table: ScheduleTable, start_epoch_s: int, window_s: int = 1,
              tz=_UTC) -> torch.Tensor:
    """[J, window_s] bool: fire decisions for every job over the window of
    seconds [start, start + window_s), wall-decomposed in ``tz``.  Fires are
    evaluated at the logical second; ``table.jitter`` is not read."""
    fw = torch.from_numpy(window_field_matrix(start_epoch_s, window_s, tz)
                          ).to(table.device)
    return _fire_mask(table, *fw.unbind(1))


# ---------------------------------------------------------------- next fire

# The reference gives up a Next() search after five years (spec.go:70-75).
FIVE_YEARS_S = 5 * 366 * 86400


def first_fire_offset(fire_jw: torch.Tensor):
    """First true offset per row, and whether any exists: ([J] int32,
    [J] bool)."""
    return _first_true(fire_jw).to(torch.int32), fire_jw.any(dim=1)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """[J] int64 index of each row's first true column (0 for none):
    ``argmax`` returns the first maximal index, and takes uint8, not bool,
    on every device."""
    return m.to(torch.uint8).argmax(dim=1)


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of int32 bit patterns; 32 when empty.  The
    lowest set bit ``v & -v`` of the unsigned value is a power of two
    2^k (k <= 31), whose float64 log2 rounds to k exactly."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    low = (v & -v).clamp(min=1)
    k = torch.round(torch.log2(low.to(torch.float64))).to(torch.int32)
    return torch.where(v == 0, 32, k)


def _ctz64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of a (lo, hi) 32-bit pair; 64 when empty."""
    return torch.where(lo != 0, _ctz32(lo), 32 + _ctz32(hi))


_SEC_PAD = 64      # padded partial-minute window
_MIN_PAD = 3072    # padded minute window (through end of tomorrow, any DST)
_DAY_PAD = 1856    # padded day window (5-year horizon)

# THE single definition of the packed host->device field buffer: the pack in
# next_fire and the unpack in _unpack both iterate it
_PACK_LAYOUT = (
    (_SEC_PAD, ("s_sec", "s_min", "s_hour", "s_dom", "s_month", "s_dow",
                "s_rel", "s_ok")),
    (_MIN_PAD, ("m_min", "m_hour", "m_dom", "m_month", "m_dow",
                "m_rel", "m_ok")),
    (_DAY_PAD, ("d_dom", "d_month", "d_dow", "d_rel", "d_ok")),
)

# Rows per pass of the scans.  The minute scan's eager intermediates are
# [rows, _MIN_PAD] int32 (400 MB at 32768 rows, a few alive at once), so a
# 2^20-row table runs in 32 passes with well under 2 GB in flight.
NEXT_FIRE_CHUNK = 1 << 15


def _unpack(buf: torch.Tensor) -> dict:
    """Views of the single uploaded field buffer, by name; the ``*_ok``
    masks as bool."""
    f, off = {}, 0
    for size, names in _PACK_LAYOUT:
        for name in names:
            f[name] = buf[off:off + size]
            off += size
    for name in ("s_ok", "m_ok", "d_ok"):
        f[name] = f[name] != 0
    return f


def _row_chunks(table: ScheduleTable):
    """(lo, hi, table rows [lo, hi) as views) per pass of NEXT_FIRE_CHUNK."""
    for lo in range(0, table.capacity, NEXT_FIRE_CHUNK):
        hi = min(lo + NEXT_FIRE_CHUNK, table.capacity)
        yield lo, hi, ScheduleTable(**{
            fl.name: getattr(table, fl.name)[lo:hi]
            for fl in dataclasses.fields(table)})


def _tod(t: ScheduleTable):
    """Each row's first fire second in a minute and first fire time of day
    (static per row): ([J] int32, [J] int32)."""
    sec0 = _ctz64(t.sec_lo, t.sec_hi).clamp(max=59)
    tod = (_ctz32(t.hour) * 3600
           + _ctz64(t.min_lo, t.min_hi).clamp(max=59) * 60 + sec0)
    return sec0, tod


def _next_fire_fused(t: ScheduleTable, f: dict, t_rel_start: int):
    """One pass resolving Schedule.Next for every row of ``t``:

    - @every rows: modular arithmetic, no scan;
    - cron rows, coarse-to-fine coverage:
      1. the partial first minute at second granularity ([J, 64]);
      2. minute granularity through the end of tomorrow ([J, 3072]) — a
         row matches a minute iff min/hour/day/month match; the fire second
         in it is the seconds mask's lowest bit;
      3. day granularity over the 5-year horizon ([J, 1856]) — a row
         matches a day iff dom/month/dow match; its first fire time of day
         is static.

    Returns ([J] int32 framework-relative fire seconds, -1 = none in the
    horizon; [J] int32 day index for rows resolved by the day scan, else
    -1)."""
    live = t.active & ~t.paused
    fire_s = (
        _bit60(t.sec_lo, t.sec_hi, f["s_sec"])
        & _bit60(t.min_lo, t.min_hi, f["s_min"])
        & _bit32(t.hour, f["s_hour"])
        & _day_ok(t, f["s_dom"], f["s_dow"])
        & _bit32(t.month, f["s_month"])
    ) & f["s_ok"][None, :]
    any_s = fire_s.any(dim=1)
    res_s = f["s_rel"][_first_true(fire_s)]
    del fire_s
    sec0, tod = _tod(t)

    match_m = (
        _bit60(t.min_lo, t.min_hi, f["m_min"])
        & _bit32(t.hour, f["m_hour"])
        & _day_ok(t, f["m_dom"], f["m_dow"])
        & _bit32(t.month, f["m_month"])
    ) & f["m_ok"][None, :]
    any_m = match_m.any(dim=1)
    res_m = f["m_rel"][_first_true(match_m)] + sec0
    del match_m

    match_d = (_day_ok(t, f["d_dom"], f["d_dow"])
               & _bit32(t.month, f["d_month"])) & f["d_ok"][None, :]
    any_d = match_d.any(dim=1)
    idx_d = _first_true(match_d)
    res_d = f["d_rel"][idx_d] + tod

    res_cron = torch.where(any_s, res_s,
                           torch.where(any_m, res_m,
                                       torch.where(any_d, res_d, -1)))
    rem = torch.remainder(t.phase_mod - t_rel_start, t.period)
    res = torch.where(t.is_every, t_rel_start + rem, res_cron)
    by_day = live & ~t.is_every & ~any_s & ~any_m & any_d
    return (torch.where(live, res, -1),
            torch.where(by_day, idx_d, -1).to(torch.int32))


def _pad_fields(f: dict, n: int, pad: int):
    """Pad field arrays to a static width with never-matching values
    (month 0 has no bit in any month mask; dow 7 in no dow mask)."""
    out = {}
    for k, v in f.items():
        fill = {"month": 0, "dow": 7, "dom": 0}.get(k, 0)
        out[k] = np.concatenate(
            [v[:n], np.full(pad - min(n, len(v)), fill, np.int32)])
    ok = np.zeros(pad, bool)
    ok[:n] = True
    return out, ok


def _local_midnights(first: _dt.datetime, n: int, tz) -> np.ndarray:
    """Epochs of ``n`` consecutive local midnights from the naive date
    ``first`` (zoneinfo resolves each across transitions)."""
    starts, cur = [], first
    for _ in range(n):
        starts.append(cur.replace(tzinfo=tz).timestamp())
        cur += _dt.timedelta(days=1)
    return np.asarray(starts, np.int64)


def next_fire(table: ScheduleTable, after_epoch_s: int, tz=_UTC,
              horizon_s: int = FIVE_YEARS_S) -> np.ndarray:
    """Batched Schedule.Next: for every row, the first fire instant strictly
    after ``after_epoch_s``.  Returns [J] int64 epoch seconds; -1 where no
    fire occurs within ``horizon_s`` (the reference's zero time).

    The window fields go to the table's device as one packed upload, the
    scans run there in passes of ``NEXT_FIRE_CHUNK`` rows, and the result
    comes back in one copy.  In DST zones, rows resolved by the day scan
    onto a transition day are re-walked with the scalar engine."""
    dev = table.device
    start = after_epoch_s + 1
    t_rel_start = start - FRAMEWORK_EPOCH
    boundary = (start // 60 + 1) * 60
    w0 = boundary - start

    # window shapes (host): partial minute, minutes to end of tomorrow, days
    # across the horizon
    off = tz_fixed_offset_seconds(tz)
    n_day = min(_DAY_PAD, (horizon_s + 86399) // 86400)
    if off is not None:
        # local midnight of the day after tomorrow
        day0 = ((boundary + off) // 86400 + 2) * 86400 - off
        n_min = (day0 - boundary) // 60
        day_starts = day0 + 86400 * np.arange(n_day, dtype=np.int64)
    else:
        loc = _dt.datetime.fromtimestamp(boundary, tz)
        d0 = _dt.datetime(loc.year, loc.month, loc.day) + _dt.timedelta(days=2)
        day_starts = _local_midnights(d0, n_day, tz)
        n_min = int((day_starts[0] - boundary) // 60)

    sf = window_fields(start, min(w0, _SEC_PAD) or 1, tz=tz)
    sf, s_ok = _pad_fields(sf, w0, _SEC_PAD)
    s_rel = (start + np.arange(_SEC_PAD, dtype=np.int64)
             - FRAMEWORK_EPOCH).astype(np.int32)

    n_min = min(n_min, _MIN_PAD)
    mf = window_fields(boundary, n_min, step_s=60, tz=tz)
    mf, m_ok = _pad_fields(mf, n_min, _MIN_PAD)
    m_rel = (boundary + 60 * np.arange(_MIN_PAD, dtype=np.int64)
             - FRAMEWORK_EPOCH).astype(np.int32)

    dfields = {"dom": np.empty(0, np.int32), "month": np.empty(0, np.int32),
               "dow": np.empty(0, np.int32)}
    if n_day:
        _, _, _, d_dom, d_month, d_dow = _decompose_days(day_starts, tz)
        dfields = {"dom": d_dom, "month": d_month, "dow": d_dow}
    df, d_ok = _pad_fields(dfields, n_day, _DAY_PAD)
    d_rel = np.zeros(_DAY_PAD, np.int64)
    d_rel[:n_day] = day_starts - FRAMEWORK_EPOCH

    fields = {
        "s_sec": sf["sec"], "s_min": sf["min"], "s_hour": sf["hour"],
        "s_dom": sf["dom"], "s_month": sf["month"], "s_dow": sf["dow"],
        "s_rel": s_rel, "s_ok": s_ok,
        "m_min": mf["min"], "m_hour": mf["hour"], "m_dom": mf["dom"],
        "m_month": mf["month"], "m_dow": mf["dow"],
        "m_rel": m_rel, "m_ok": m_ok,
        "d_dom": df["dom"], "d_month": df["month"], "d_dow": df["dow"],
        "d_rel": d_rel, "d_ok": d_ok,
    }
    packed = np.concatenate([
        np.asarray(fields[name]).astype(np.int32)
        for size, names in _PACK_LAYOUT for name in names])
    f = _unpack(torch.from_numpy(packed).to(dev))
    out = torch.empty((2, table.capacity), dtype=torch.int32, device=dev)
    for lo, hi, rows in _row_chunks(table):
        out[0, lo:hi], out[1, lo:hi] = _next_fire_fused(rows, f, t_rel_start)
    res_rel, day_idx = out.cpu().numpy().astype(np.int64)
    result = np.where(res_rel < 0, -1, res_rel + FRAMEWORK_EPOCH)

    if off is None:
        _fix_dst_days(table, result, day_idx, day_starts, tz)

    # The fused pass scans _DAY_PAD days; an explicit horizon beyond that
    # continues in further day-window chunks.  int32 framework-relative
    # seconds bound the scan to ~2088; 20 years is already 4x the
    # reference's give-up horizon (spec.go:70-75).
    days_done = n_day
    horizon_days = min((horizon_s + 86399) // 86400, 20 * 366)
    cron_live = None
    while days_done < horizon_days:
        if cron_live is None:
            cron_live = (~table.is_every & table.active
                         & ~table.paused).cpu().numpy()
        unresolved = (result < 0) & cron_live
        if not unresolved.any():
            break
        nd = min(_DAY_PAD, horizon_days - days_done)
        if off is not None:
            chunk_starts = day_starts[0] + 86400 * np.arange(
                days_done, days_done + nd, dtype=np.int64)
        else:
            cur = _dt.datetime.fromtimestamp(int(day_starts[-1]), tz)
            base = _dt.datetime(cur.year, cur.month, cur.day) \
                + _dt.timedelta(days=days_done - n_day + 1)
            chunk_starts = _local_midnights(base, nd, tz)
        _, _, _, cd_dom, cd_month, cd_dow = _decompose_days(chunk_starts, tz)
        cdf, cd_ok = _pad_fields(
            {"dom": cd_dom, "month": cd_month, "dow": cd_dow}, nd, _DAY_PAD)
        cd_rel = np.zeros(_DAY_PAD, np.int64)
        cd_rel[:nd] = chunk_starts - FRAMEWORK_EPOCH
        found, res_rel2, idx2 = _day_scan(
            table, cdf["dom"], cdf["month"], cdf["dow"], cd_rel, cd_ok)
        hit = unresolved & found
        result[hit] = res_rel2[hit].astype(np.int64) + FRAMEWORK_EPOCH
        if off is None:
            _fix_dst_days(table, result, np.where(hit, idx2, -1),
                          chunk_starts, tz)
        days_done += nd

    # horizon clip (@every with huge periods / last chunk can exceed it)
    return np.where(result > after_epoch_s + horizon_s, -1, result)


def _day_scan(table: ScheduleTable, d_dom, d_month, d_dow, d_rel, d_ok):
    """Day-granularity continuation chunk: per row, whether a day matches,
    the first matching day's start plus the row's static first time of
    day, and that day's index — host arrays, one copy back."""
    dev = table.device
    cols = torch.from_numpy(np.stack([d_dom, d_month, d_dow,
                                      d_rel.astype(np.int32),
                                      d_ok.astype(np.int32)])).to(dev)
    dom, month, dow, rel, ok = cols.unbind(0)
    out = torch.empty((3, table.capacity), dtype=torch.int32, device=dev)
    for lo, hi, t in _row_chunks(table):
        match_d = (_day_ok(t, dom, dow) & _bit32(t.month, month)
                   ) & (ok != 0)[None, :]
        idx = _first_true(match_d)
        out[0, lo:hi] = match_d.any(dim=1).to(torch.int32)
        out[1, lo:hi] = rel[idx] + _tod(t)[1]
        out[2, lo:hi] = idx.to(torch.int32)
    found, res, idx = out.cpu().numpy()
    return found != 0, res, idx


def _decompose_days(day_starts: np.ndarray, tz):
    """Civil fields for local-midnight day starts (noon probe avoids DST
    edge effects on the date itself)."""
    off = tz_fixed_offset_seconds(tz)
    if off is not None:
        return decompose_utc(day_starts + 43200, off)
    dom = np.empty(len(day_starts), np.int32)
    month = np.empty(len(day_starts), np.int32)
    dow = np.empty(len(day_starts), np.int32)
    for i, s in enumerate(day_starts):
        loc = _dt.datetime.fromtimestamp(int(s) + 43200, tz)
        dom[i] = loc.day
        month[i] = loc.month
        dow[i] = (loc.weekday() + 1) % 7
    return None, None, None, dom, month, dow


_SPEC_COLS = ("sec_lo", "sec_hi", "min_lo", "min_hi", "hour", "dom", "month",
              "dow", "dom_star", "dow_star")


def _fix_dst_days(table: ScheduleTable, result: np.ndarray,
                  day_idx: np.ndarray, day_starts: np.ndarray, tz):
    """Rows the day scan resolved onto a DST-transition day get an exact
    scalar re-walk (static time-of-day arithmetic assumes 86400-s days).
    The affected rows' masks come back in one copy."""
    if not len(day_starts):
        return
    lengths = np.diff(np.concatenate([day_starts, day_starts[-1:] + 86400]))
    affected = np.nonzero((day_idx >= 0)
                          & (lengths[np.clip(day_idx, 0, len(lengths) - 1)]
                             != 86400))[0]
    if not len(affected):
        return
    from ..cron.parser import CronSpec, STAR_BIT
    from ..cron.schedule import Schedule
    rows = torch.as_tensor(affected, device=table.device)
    cols = torch.stack([getattr(table, k)[rows].to(torch.int64)
                        for k in _SPEC_COLS], 1).cpu().numpy()
    cols[:, :8] &= 0xFFFFFFFF                      # the uint32 bit patterns
    for j, (slo, shi, mlo, mhi, hour, dom, month, dow, dom_star,
            dow_star) in zip(affected, cols.tolist()):
        spec = CronSpec(
            second=slo | shi << 32, minute=mlo | mhi << 32, hour=hour,
            month=month, dom=dom | (STAR_BIT if dom_star else 0),
            dow=dow | (STAR_BIT if dow_star else 0))
        t0 = _dt.datetime.fromtimestamp(int(day_starts[day_idx[j]]) - 1, tz)
        nxt = Schedule(spec).next(t0)
        result[j] = -1 if nxt is None else int(nxt.timestamp())


def next_fire_one(table: ScheduleTable, job_index: int, after_epoch_s: int,
                  tz=_UTC) -> Optional[int]:
    """Convenience: next fire for one row (None if unsatisfiable)."""
    v = int(next_fire(table, after_epoch_s, tz=tz)[job_index])
    return None if v < 0 else v
