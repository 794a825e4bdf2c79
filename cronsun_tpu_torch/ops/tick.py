"""Windowed fire-mask evaluation (counterpart of ``cronsun_tpu/ops/tick.py``,
its fire-mask half).

:func:`fire_mask` is one elementwise program over the whole schedule table:
six bitmask membership tests, the DOM/DOW star rule and the ``@every``
modular test, [J, W] bool for a window of W seconds.  The calendar fields of
each window second are decided on the host (:mod:`.timecal`), which keeps
the device program timezone- and DST-agnostic.

Mask columns are int32 bit patterns (see :mod:`.schedule_table`); the shift
amounts are clamped to 0..31, so ``(x >> s) & 1`` reads bit ``s`` whether
the 32 bits are read as signed or unsigned.
"""

from __future__ import annotations

from datetime import timezone

import numpy as np
import torch

from .schedule_table import FRAMEWORK_EPOCH, ScheduleTable
from .timecal import window_fields

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
