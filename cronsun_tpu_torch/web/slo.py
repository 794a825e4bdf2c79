"""SLO engine: multi-window multi-burn-rate alerting on the web tier.

Declarative SLO records (core.models.SloSpec) live under the ``slo/``
keyspace family.  Each evaluation tick the engine

1. lists the specs,
2. scrapes the per-scope execution counters every agent publishes in
   its leased metrics snapshot (``metrics/node/<id>`` -> ``"slo"``:
   {scope: {count, fail, sum_ms, buckets}}) and SUMS them fleet-wide
   (fixed bucket bounds make the histograms addable — dead agents'
   numbers expire with their lease),
3. appends the sums to a bounded per-scope sample ring (~6h), and
4. computes burn rates over the four canonical windows.

Burn rate = bad_fraction / (1 - target), where an execution is bad
when it failed or (``latency_ms`` > 0) ran longer than the threshold —
counted from the histogram buckets, so the threshold snaps to a bucket
bound (pick thresholds from trace.BUCKETS_MS).

Alerting follows the Google SRE-workbook ladder: a FAST page when the
burn exceeds 14.4 over BOTH the 5m and 1h windows (2% of a 30-day
budget in one hour), a SLOW page at 6 over BOTH 30m and 6h.  Requiring
both windows keeps a brief spike from paging while still catching a
sustained burn within minutes.  Transitions into alert write ONE
rate-limited notice key through the noticer (the breaker-paging
pattern); recovery clears the state without paging.

``cronsun_slo_burn_rate{slo=,window=}`` and
``cronsun_slo_alert{slo=,severity=}`` render at /v1/metrics.

Copy of ``cronsun_tpu/web/slo.py``.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import log, trace as _trace
from ..core import Keyspace
from ..core.models import SloSpec

# (severity, short window, long window, burn threshold)
WINDOWS = (("fast", "5m", "1h", 14.4),
           ("slow", "30m", "6h", 6.0))
WINDOW_LABELS = ("5m", "30m", "1h", "6h")
_WINDOW_S = {"5m": 300.0, "30m": 1800.0, "1h": 3600.0, "6h": 21600.0}


class SloEngine:
    def __init__(self, store, ks: Optional[Keyspace] = None,
                 interval_s: float = 15.0,
                 notice_interval_s: float = 300.0,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.ks = ks or Keyspace()
        self.interval_s = max(1.0, float(interval_s))
        self.notice_interval_s = notice_interval_s
        self.clock = clock
        self._mu = threading.Lock()
        # scope -> [(ts, count, fail, buckets tuple)] sample ring
        self._ring: Dict[str, List[tuple]] = {}
        self._ring_keep = 21600.0 + 4 * self.interval_s
        # slo name -> {"burn": {window: x}, "alert": ""|"fast"|"slow",
        #              "since": ts}
        self._state: Dict[str, dict] = {}
        self._last_sums: Optional[Dict[str, list]] = None
        self._last_notice: Dict[str, float] = {}
        self.stats = {"slo_evals_total": 0, "slo_alerts_total": 0,
                      "slo_notices_total": 0, "slo_recoveries_total": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- spec + scrape plumbing -----------------------------------------

    def specs(self) -> List[SloSpec]:
        out = []
        for kv in self.store.get_prefix(self.ks.slo):
            try:
                spec = SloSpec.from_json(kv.value)
                spec.validate()
                out.append(spec)
            except Exception:  # noqa: BLE001 — skip malformed records
                continue
        return out

    def _scrape(self) -> Dict[str, list]:
        """Sum the per-scope SLO counters across every live agent
        snapshot: scope -> [count, fail, sum_ms, buckets, fbuckets]
        (fbuckets = failure-latency histogram; a legacy agent without
        it sums as zeros and _bad_good falls back conservatively)."""
        sums: Dict[str, list] = {}

        def add(tb: list, b) -> None:
            if len(tb) < len(b):
                tb.extend([0] * (len(b) - len(tb)))
            for i, v in enumerate(b):
                tb[i] += int(v)

        for kv in self.store.get_prefix(self.ks.metrics + "node/"):
            try:
                snap = json.loads(kv.value)
            except json.JSONDecodeError:
                continue
            slo = snap.get("slo")
            if not isinstance(slo, dict):
                continue
            for scope, ent in slo.items():
                if not isinstance(ent, dict):
                    continue
                tgt = sums.setdefault(scope, [0, 0, 0.0, [], []])
                tgt[0] += int(ent.get("count", 0))
                tgt[1] += int(ent.get("fail", 0))
                tgt[2] += float(ent.get("sum_ms", 0.0))
                add(tgt[3], ent.get("buckets") or [])
                add(tgt[4], ent.get("fbuckets") or [])
        return sums

    # ---- evaluation ------------------------------------------------------

    def tick(self):
        """One evaluation pass (the background loop calls this every
        ``interval_s``; tests drive it directly)."""
        now = self.clock()
        sums = self._scrape()
        with self._mu:
            self._last_sums = sums
            for scope, (count, fail, sum_ms, buckets,
                        fbuckets) in sums.items():
                ring = self._ring.setdefault(scope, [])
                ring.append((now, count, fail, tuple(buckets),
                             tuple(fbuckets)))
                cut = now - self._ring_keep
                while len(ring) > 2 and ring[0][0] < cut:
                    ring.pop(0)
            self.stats["slo_evals_total"] += 1
        specs = self.specs()
        for spec in specs:
            self._eval_spec(spec, now)
        # a DELETED spec must not keep rendering (or alerting) forever:
        # drop engine state for names no longer in the keyspace
        live = {s.name for s in specs}
        with self._mu:
            for name in [n for n in self._state if n not in live]:
                del self._state[name]
                self._last_notice.pop(name, None)

    def _sample_at(self, ring: List[tuple], ts: float):
        """Newest sample at or before ``ts`` — or the OLDEST sample
        (partial-window evaluation: a burn must be visible before a
        full 6h of history exists)."""
        prev = ring[0]
        for s in ring:
            if s[0] > ts:
                break
            prev = s
        return prev

    def _bad_good(self, sample, spec: SloSpec):
        """(bad, total) cumulative at one sample for one spec.  bad =
        failed OR slower than the latency threshold.  With failure
        buckets the joint is exact: bad = fail + slow successes =
        (count - fast_all) + fast_fail.  Without them (legacy agent
        snapshots sum to all-zero fbuckets while fail > 0) the clamp
        assumes every failure was slow — the conservative lower bound
        the engine always used."""
        _ts, count, fail, buckets, fbuckets = sample
        bad = fail
        if spec.latency_ms > 0 and buckets:
            k = bisect.bisect_right(_trace.BUCKETS_MS, spec.latency_ms)
            fast_all = sum(buckets[:k])
            fast_fail = sum(fbuckets[:k])
            if fail and not any(fbuckets):
                bad += max(0, count - fast_all - fail)
            else:
                bad = max(fail, (count - fast_all) + fast_fail)
        return bad, count

    def burn_rates(self, spec: SloSpec) -> Dict[str, float]:
        """Burn rate per canonical window from the counter deltas."""
        scope = spec.counter_scope
        with self._mu:
            ring = list(self._ring.get(scope) or [])
        out = {}
        if len(ring) < 2:
            return {w: 0.0 for w in WINDOW_LABELS}
        newest = ring[-1]
        nb, nt = self._bad_good(newest, spec)
        for label in WINDOW_LABELS:
            base = self._sample_at(ring[:-1],
                                   newest[0] - _WINDOW_S[label])
            bb, bt = self._bad_good(base, spec)
            total = nt - bt
            bad = max(0, nb - bb)
            frac = (bad / total) if total > 0 else 0.0
            out[label] = round(frac / max(1e-9, 1.0 - spec.target), 3)
        return out

    def _eval_spec(self, spec: SloSpec, now: float):
        burn = self.burn_rates(spec)
        severity = ""
        for label, short_l, long_l, thresh in WINDOWS:
            if burn[short_l] >= thresh and burn[long_l] >= thresh:
                severity = label
                break           # fast outranks slow
        with self._mu:
            st = self._state.setdefault(
                spec.name, {"burn": {}, "alert": "", "since": 0.0,
                            "scope": spec.scope, "target": spec.target,
                            "latency_ms": spec.latency_ms})
            st["burn"] = burn
            st["scope"] = spec.scope
            st["target"] = spec.target
            st["latency_ms"] = spec.latency_ms
            was = st["alert"]
            if severity and not was:
                st["alert"] = severity
                st["since"] = now
                self.stats["slo_alerts_total"] += 1
                fire = True
            elif not severity and was:
                st["alert"] = ""
                st["since"] = now
                self.stats["slo_recoveries_total"] += 1
                fire = False
            else:
                st["alert"] = severity or ""
                fire = False
        if fire:
            self._page(spec, severity, burn, now)

    def _page(self, spec: SloSpec, severity: str, burn: dict,
              now: float):
        """Write ONE rate-limited notice key through the noticer (the
        breaker-paging ladder): a flapping SLO pages once per
        ``notice_interval_s``, not once per transition."""
        last = self._last_notice.get(spec.name, 0.0)
        if now - last < self.notice_interval_s:
            return
        self._last_notice[spec.name] = now
        key = self.ks.noticer_key(f"slo-{spec.name}")
        body = json.dumps({
            "subject": f"[cronsun] SLO {spec.name} {severity}-burn "
                       f"alert",
            "body": f"SLO {spec.name} (scope {spec.scope or 'global'}, "
                    f"target {spec.target}"
                    + (f", latency <= {spec.latency_ms}ms"
                       if spec.latency_ms else "")
                    + f") is burning error budget: "
                    f"burn rates 5m={burn['5m']} 1h={burn['1h']} "
                    f"30m={burn['30m']} 6h={burn['6h']}. "
                    "See cronsun_slo_burn_rate at /v1/metrics and "
                    "cronsun-ctl slo show."})
        try:
            self.store.put(key, body)
            self.stats["slo_notices_total"] += 1
        except Exception as e:  # noqa: BLE001 — the gauge is the
            # real-time signal; the page retries on the next interval
            log.warnf("slo notice for %s could not be written: %s",
                      spec.name, e)
            self._last_notice[spec.name] = 0.0

    # ---- surfaces --------------------------------------------------------

    def snapshot(self) -> dict:
        """Current burn rates + alert states for /v1/slo and the
        /v1/metrics gauges."""
        with self._mu:
            states = {name: {"burn": dict(st["burn"]),
                             "alert": st["alert"],
                             "since": st["since"],
                             "scope": st.get("scope", ""),
                             "target": st.get("target", 0.0),
                             "latency_ms": st.get("latency_ms", 0.0)}
                      for name, st in self._state.items()}
            stats = dict(self.stats)
        return {"slos": states, "stats": stats}

    def scrape_sums(self) -> Dict[str, list]:
        """Latest per-scope counter sums (for the exec-latency
        histogram rendering at /v1/metrics): scope -> [count, fail,
        sum_ms, buckets]."""
        with self._mu:
            return {scope: [v[0], v[1], v[2], list(v[3])]
                    for scope, v in (self._last_sums or {}).items()}

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — keep evaluating
                    log.warnf("slo eval failed: %s", e)
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
