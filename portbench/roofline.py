"""Peaks of the cards and the least bytes the port's two kernels move.

The byte model is a copy of ``chip_smoke.py``'s ``k1_work`` and ``k2_work``
(lines 511-545 at this benchmark's writing; PERF.md's kernel table): each
input byte read once and each output byte written once, the eligibility
words only of the rows that do work.  Both kernels are bound by bytes there
(PERF.md: K1 10.5x and K2 7.1x their byte bound on the headline path), so a
share of the byte bound is a share of the roofline.
"""

from __future__ import annotations

from typing import Optional

# HBM bytes per second, by ``torch.cuda.get_device_name()``: the published
# peak of each part (NVIDIA's data sheets)
PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,     # SXM
}


def peak_bytes_s(device_kind: str) -> Optional[float]:
    return PEAK_BYTES_S.get(device_kind)


def k1_bytes(active_rows: int, bucket: int, w32: int) -> int:
    """K1 (``bid_argmin`` with ``rows`` and ``active``): the active rows'
    eligibility words, the effective load of every node, the bucket's row
    ids (int32) and active flags (bool) in; best (f32) and choice (int32)
    out."""
    return 4 * active_rows * w32 + 4 * w32 * 32 + 8 * bucket + 5 * bucket


def k2_bytes(weighted_rows: int, bucket: int, w32: int) -> int:
    """K2 (``fanout_add`` with ``rows``): the words of the rows of nonzero
    weight, the bucket's weights (f32) and row ids (int32) in; one f32 load
    a node out."""
    return 4 * weighted_rows * w32 + 4 * bucket + 4 * w32 * 32 + 4 * bucket
