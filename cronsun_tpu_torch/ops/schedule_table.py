"""Device-resident batched schedule table (counterpart of
``cronsun_tpu/ops/schedule_table.py``).

A compiled cron spec is six 64-bit bitmasks; each is stored as a (lo, hi)
pair of 32-bit words with the star bits hoisted into bool columns (they only
matter for the day-of-month vs day-of-week rule).  ``@every`` schedules ride
the same table as (period, phase) rows: a row fires when
``(t - phase) mod period == 0``.  Epoch arithmetic is relative to
:data:`FRAMEWORK_EPOCH` so device seconds fit int32.

**Bit patterns.** PyTorch on the CPU implements no right shift for uint32,
so every uint32 column is stored as an int32 tensor holding the same 32 bits
(``np.ndarray.view(np.int32)``).  A bit test ``(x >> s) & 1`` for
``s <= 31`` reads the same bit from either type; :func:`table_to_numpy`
views the columns back as uint32.

Tables are fixed-capacity and ``active`` marks live rows; row churn is an
in-place scatter (:func:`update_rows`), never a reshape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..cron.parser import CronSpec, EverySpec, parse
from ..device import DeviceLike, resolve_device

# 2020-01-01T00:00:00Z — device times are int32 seconds relative to this.
FRAMEWORK_EPOCH = 1577836800

# Upstream slots per dep-triggered row (cronsun_tpu/core/models.py:29).
MAX_DEPS = 8

_MASK32 = (1 << 32) - 1
_STAR_OFF = ~(1 << 63)  # strip star bit before splitting

# dependency-column sentinels: >= 0 is an upstream row; DEP_EMPTY pads
# unused slots (always satisfied); DEP_BROKEN never satisfies.
DEP_EMPTY = -1
DEP_BROKEN = -2


def _split64(mask: int) -> "tuple[int, int]":
    m = mask & _STAR_OFF
    return m & _MASK32, (m >> 32) & _MASK32


@dataclasses.dataclass
class ScheduleTable:
    """Struct-of-arrays schedule batch; every field is shape [capacity]
    except ``dep_cols`` [capacity, MAX_DEPS].  Field meanings are those of
    the JAX table; the uint32 columns hold int32 bit patterns."""

    sec_lo: torch.Tensor   # uint32 bits as int32
    sec_hi: torch.Tensor   # uint32 bits as int32 (bits 32..59)
    min_lo: torch.Tensor   # uint32 bits as int32
    min_hi: torch.Tensor   # uint32 bits as int32
    hour: torch.Tensor     # uint32 bits as int32 (bits 0..23)
    dom: torch.Tensor      # uint32 bits as int32 (bits 1..31)
    month: torch.Tensor    # uint32 bits as int32 (bits 1..12)
    dow: torch.Tensor      # uint32 bits as int32 (bits 0..6)
    dom_star: torch.Tensor  # bool
    dow_star: torch.Tensor  # bool
    is_every: torch.Tensor  # bool
    period: torch.Tensor    # int32, >= 1 always
    phase_mod: torch.Tensor  # int32, phase mod period
    active: torch.Tensor    # bool — live row
    paused: torch.Tensor    # bool — Job.Pause
    has_dep: torch.Tensor   # bool — dep-triggered row (not yet armed)
    dep_policy: torch.Tensor  # int32
    dep_cols: torch.Tensor    # int32 [capacity, MAX_DEPS]
    tenant: torch.Tensor      # int32 (not yet armed)
    jitter: torch.Tensor      # int32 — host-side herd smear, never read here

    @property
    def capacity(self) -> int:
        return self.sec_lo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sec_lo.device


# numpy dtypes of the JAX table's columns (the uint32 ones travel as int32)
DTYPES = dict(
    sec_lo=np.uint32, sec_hi=np.uint32, min_lo=np.uint32, min_hi=np.uint32,
    hour=np.uint32, dom=np.uint32, month=np.uint32, dow=np.uint32,
    dom_star=np.bool_, dow_star=np.bool_, is_every=np.bool_,
    period=np.int32, phase_mod=np.int32, active=np.bool_, paused=np.bool_,
    has_dep=np.bool_, dep_policy=np.int32, dep_cols=np.int32,
    tenant=np.int32, jitter=np.int32,
)

# per-field trailing shape beyond [capacity] (only the dep matrix is 2-D)
_SHAPES = {"dep_cols": (MAX_DEPS,)}

_NO_DEPS = (DEP_EMPTY,) * MAX_DEPS

_INACTIVE_ROW = dict(
    sec_lo=0, sec_hi=0, min_lo=0, min_hi=0, hour=0, dom=0, month=0, dow=0,
    dom_star=False, dow_star=False, is_every=False, period=1, phase_mod=0,
    active=False, paused=False,
    has_dep=False, dep_policy=0, dep_cols=_NO_DEPS, tenant=0, jitter=0)


def make_row(spec: Union[CronSpec, EverySpec, str], phase_epoch_s: int = 0,
             paused: bool = False, tenant: int = 0,
             jitter: int = 0) -> dict:
    """Host-side row dict for one spec (strings are parsed)."""
    if isinstance(spec, str):
        spec = parse(spec)
    if isinstance(spec, EverySpec):
        period = max(1, spec.period_s)
        return dict(
            sec_lo=0, sec_hi=0, min_lo=0, min_hi=0, hour=0, dom=0, month=0,
            dow=0, dom_star=False, dow_star=False, is_every=True,
            period=period,
            phase_mod=int((phase_epoch_s - FRAMEWORK_EPOCH) % period),
            active=True, paused=paused,
            has_dep=False, dep_policy=0, dep_cols=_NO_DEPS, tenant=tenant,
            jitter=int(jitter))
    sec_lo, sec_hi = _split64(spec.second)
    min_lo, min_hi = _split64(spec.minute)
    return dict(
        sec_lo=sec_lo, sec_hi=sec_hi, min_lo=min_lo, min_hi=min_hi,
        hour=spec.hour & _MASK32, dom=spec.dom & _MASK32,
        month=spec.month & _MASK32, dow=spec.dow & _MASK32,
        dom_star=spec.dom_star, dow_star=spec.dow_star,
        is_every=False, period=1, phase_mod=0, active=True, paused=paused,
        has_dep=False, dep_policy=0, dep_cols=_NO_DEPS, tenant=tenant,
        jitter=int(jitter))


def make_dep_row(upstream_rows, policy: int, paused: bool = False,
                 tenant: int = 0) -> dict:
    """Row dict for a dep-triggered job: cron masks empty (the row never
    time-fires), dep columns padded to MAX_DEPS with DEP_EMPTY."""
    ups = list(upstream_rows)[:MAX_DEPS]
    cols = tuple(ups) + (DEP_EMPTY,) * (MAX_DEPS - len(ups))
    row = dict(_INACTIVE_ROW)
    row.update(active=True, paused=paused, has_dep=True,
               dep_policy=int(policy), dep_cols=cols, tenant=int(tenant))
    return row


def column_tensor(arr, dt, device: torch.device) -> torch.Tensor:
    """numpy column in the JAX table's dtype ``dt`` (for uint32, its int32
    bit patterns are taken too) -> a tensor of its own on ``device`` (a
    copy, never a view of the caller's array); uint32 travels as int32."""
    arr = np.asarray(arr)
    if not (dt == np.uint32 and arr.dtype == np.int32):
        arr = arr.astype(dt, copy=False)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.tensor(arr, device=device)


def column_numpy(t: torch.Tensor, dt) -> np.ndarray:
    """Host copy of a column in the JAX dtype ``dt`` (inverse of
    :func:`column_tensor`)."""
    arr = t.cpu().numpy().copy()
    return arr.view(np.uint32) if dt == np.uint32 else arr


def table_from_numpy(cols: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> ScheduleTable:
    """Install numpy columns (the JAX table's dtypes, or int32 bit patterns
    for the uint32 ones) as a table on ``device``."""
    dev = resolve_device(device)
    missing = set(DTYPES) - set(cols)
    if missing:
        raise ValueError(f"missing table columns: {sorted(missing)}")
    return ScheduleTable(**{k: column_tensor(cols[k], dt, dev)
                            for k, dt in DTYPES.items()})


def table_to_numpy(table: ScheduleTable) -> Dict[str, np.ndarray]:
    """Host copies of every column in the JAX table's dtypes."""
    return {k: column_numpy(getattr(table, k), dt) for k, dt in DTYPES.items()}


def _rows_to_numpy(rows: List[dict], n: int) -> Dict[str, np.ndarray]:
    cols = {k: np.full((n, *_SHAPES.get(k, ())),
                       DEP_EMPTY if k == "dep_cols" else _INACTIVE_ROW[k],
                       dtype=dt)
            for k, dt in DTYPES.items()}
    for i, row in enumerate(rows):
        for k, v in row.items():
            cols[k][i] = v
    return cols


def build_table(specs: List[Union[CronSpec, EverySpec, str]],
                capacity: Optional[int] = None,
                phase_epoch_s: int = 0,
                paused: Optional[List[bool]] = None,
                device: DeviceLike = None) -> ScheduleTable:
    """Compile a list of specs into a ScheduleTable on ``device``.

    ``capacity`` pads the table (inactive rows) to a fixed size; defaults to
    the next power of two >= len(specs)."""
    n = len(specs)
    if capacity is None:
        capacity = max(1, 1 << (n - 1).bit_length()) if n else 1
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} specs")
    rows = [make_row(spec, phase_epoch_s=phase_epoch_s,
                     paused=bool(paused[i]) if paused else False)
            for i, spec in enumerate(specs)]
    cols = _rows_to_numpy(rows, capacity)
    return table_from_numpy(cols, device)


def update_rows(table: ScheduleTable, indices: np.ndarray,
                rows: List[dict]) -> ScheduleTable:
    """Overwrite the rows at ``indices`` (watch-delta path).

    Unlike the JAX version, which returns a new table, this scatters IN
    PLACE into ``table``'s tensors (no 20-column copy per delta) and returns
    the same table.  A window reads the table while it is being issued, so
    a planner's table is written only through
    ``TickPlanner.update_table_rows``, which holds the planner's lock: the
    scatter lands wholly before or wholly after any window."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                          device=table.device)
    cols = _rows_to_numpy(rows, len(rows))
    for k in DTYPES:
        getattr(table, k)[idx] = column_tensor(cols[k], DTYPES[k], table.device)
    return table


def deactivate_rows(table: ScheduleTable, indices: np.ndarray) -> ScheduleTable:
    return update_rows(table, indices, [_INACTIVE_ROW] * len(indices))
