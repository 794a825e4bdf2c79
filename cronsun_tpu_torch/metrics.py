"""Leased metrics snapshots — the fleet-wide observability protocol.

Every component (scheduler, agent) periodically puts a JSON snapshot
under ``/metrics/<component>/<instance>`` bound to a short lease, so a
dead publisher's numbers expire instead of going stale; any web server
renders the whole keyspace as Prometheus text at ``/v1/metrics``.  This
module is THE publish protocol — one place for the
keepalive-or-regrant lease dance, the ttl sizing and the
failure-must-not-stall-the-caller rule.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Optional

from . import log
from .core import Keyspace


class OpStats:
    """Per-op server-side timing/count aggregation behind one lock:
    op -> [count, total_ns, max_ns].  The shared primitive behind both
    stores' ``op_stats`` surfaces (memstore's claim/put/watch timings
    and the result store's create/query timings), so their snapshot
    shape — and the ``/v1/metrics`` rendering built on it — cannot
    drift between the two."""

    __slots__ = ("_ns", "_lock")

    def __init__(self):
        self._ns: Dict[str, list] = {}
        self._lock = threading.Lock()

    def record(self, op: str, t0_ns: int) -> None:
        dt = time.perf_counter_ns() - t0_ns
        with self._lock:
            ent = self._ns.get(op)
            if ent is None:
                self._ns[op] = [1, dt, dt]
            else:
                ent[0] += 1
                ent[1] += dt
                if dt > ent[2]:
                    ent[2] = dt

    def count(self, op: str, n: int = 1) -> None:
        """Count-only stat (no timing): contention ticks, frame/event
        tallies, per-record tallies under a bulk op."""
        with self._lock:
            ent = self._ns.get(op)
            if ent is None:
                self._ns[op] = [n, 0, 0]
            else:
                ent[0] += n

    def snapshot(self) -> dict:
        """{op: {count, total_ms, max_ms}} — the op_stats wire shape."""
        with self._lock:
            return {op: {"count": c, "total_ms": round(t / 1e6, 3),
                         "max_ms": round(m / 1e6, 3)}
                    for op, (c, t, m) in self._ns.items()}


class LatencyRing:
    """Bounded ring of recent latency samples with percentile reads —
    the shared primitive behind every ``*_p50_ms``/``*_p99_ms`` gauge
    (step cycle, device plan, per-phase spans, pipeline stage times).
    Appends are GIL-atomic list ops, so a producer thread (the step
    loop or the pipeline's build worker) never contends with the
    metrics snapshot reader."""

    __slots__ = ("cap", "_v")

    def __init__(self, cap: int = 128):
        self.cap = cap
        self._v: list = []

    def add(self, v: float) -> None:
        self._v.append(float(v))
        if len(self._v) > self.cap:
            del self._v[:-self.cap]

    def clear(self) -> None:
        self._v = []

    def __len__(self) -> int:
        return len(self._v)

    def percentile(self, p: float) -> float:
        vals = sorted(self._v)
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(p * len(vals)))]


def parse_exposition(text: str):
    """Small Prometheus text-exposition parser used by the metrics
    smoke tests (and anything that wants to machine-check /v1/metrics).
    Returns {(name, frozenset(label items)): float}; raises ValueError
    on any line that does not parse or any duplicate
    (metric, label-set) series."""
    import re
    series: Dict[tuple, float] = {}
    line_rx = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(-?[0-9.eE+-]+|'
        r'[+-]?Inf|NaN)$')
    lbl_rx = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = line_rx.match(ln)
        if not m:
            raise ValueError(f"unparseable exposition line: {ln!r}")
        name, labels_s, val = m.groups()
        labels = {}
        if labels_s:
            consumed = 0
            for lm in lbl_rx.finditer(labels_s):
                if lm.start() != consumed:
                    # unmatched bytes BETWEEN pairs (or before the
                    # first) must fail too, not just trailing ones
                    raise ValueError(
                        f"bad label section in: {ln!r}")
                labels[lm.group(1)] = lm.group(2)
                consumed = lm.end()
                if consumed < len(labels_s):
                    if labels_s[consumed] != ",":
                        raise ValueError(
                            f"bad label separator in: {ln!r}")
                    consumed += 1
            if consumed < len(labels_s):
                raise ValueError(f"trailing label garbage in: {ln!r}")
        key = (name, frozenset(labels.items()))
        if key in series:
            raise ValueError(
                f"duplicate series {name}{{{labels_s or ''}}}")
        series[key] = float(val)
    return series


class MetricsPublisher:
    def __init__(self, store, ks: Keyspace, component: str, instance: str,
                 snapshot_fn: Callable[[], dict], interval_s: float = 10.0,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.key = ks.metrics_key(component, instance)
        self.snapshot_fn = snapshot_fn
        self.interval_s = interval_s
        self.clock = clock
        self._lease: Optional[int] = None
        self._next_at = 0.0

    def maybe_publish(self):
        """Publish if the interval elapsed; errors are logged, never
        raised — metrics must not stall the caller's loop."""
        if self.clock() < self._next_at:
            return
        try:
            if self._lease is None or not self.store.keepalive(self._lease):
                self._lease = self.store.grant(self.interval_s * 3 + 5)
            self.store.put(self.key,
                           json.dumps(self.snapshot_fn(),
                                      separators=(",", ":")),
                           lease=self._lease)
        except Exception as e:  # noqa: BLE001
            log.warnf("metrics publish for %s failed: %s", self.key, e)
            self._lease = None
        self._next_at = self.clock() + self.interval_s

    def revoke(self):
        """Withdraw the snapshot immediately (clean shutdown) — the
        metrics surface must not keep rendering a gone component for the
        remaining lease TTL."""
        if self._lease is not None:
            try:
                self.store.revoke(self._lease)
            except Exception:  # noqa: BLE001 — best effort on the way out
                pass
            self._lease = None
