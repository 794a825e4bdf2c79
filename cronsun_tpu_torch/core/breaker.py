"""Per-shard circuit breaker for the sharded fan-out clients.

The classic production failure the sharded planes (store and logd)
had no model for is the BROWNED-OUT shard: alive at the TCP
level but slow — every scatter-gather read and every claim fan-out
waits on it, so one shard's 5 s stall becomes the whole plane's 5 s
stall.  A *dead* shard fails fast (connect refused, RPC error); a
*slow* one poisons everything silently.

:class:`CircuitBreaker` bounds that blast radius with the standard
three states:

- **closed** — healthy: calls pass, latencies are measured against the
  per-shard ``deadline``; ``fail_threshold`` consecutive
  deadline-or-error outcomes open the breaker.
- **open** — degraded: calls are refused IMMEDIATELY (fail-fast for
  writes/claims, skip-with-``shard_degraded``-stat for tolerant
  reads) until ``cooldown`` elapses.
- **probing** — after cooldown ONE trial call is let through; success
  closes the breaker, failure re-opens it for another cooldown.

The breaker never retries and never sleeps — policy (what a refused
call means) belongs to the caller; this class only answers "should
this call be attempted, and what happened to the last one".

Enable by deadline: ``deadline <= 0`` disables the breaker entirely
(every call allowed, nothing recorded) — the default, so existing
single-host deployments and the tier-1 suite see zero behavior change;
production fleets and the chaos drills opt in via
``CRONSUN_SHARD_DEADLINE_S`` (see store/sharded.py).

Copy of ``cronsun_tpu/core/breaker.py``; the only difference: comments that dated a
behaviour by the JAX package's history now say what it is.
"""

from __future__ import annotations

import inspect
import json
import threading
import time
from typing import Callable, List, Optional

from .. import log

CLOSED, OPEN, PROBING = "closed", "open", "probing"


class CircuitBreaker:
    __slots__ = ("deadline", "fail_threshold", "cooldown", "clock",
                 "_mu", "_state", "_fails", "_opened_at", "_probe_out",
                 "opens_total", "refused_total", "on_open")

    def __init__(self, deadline: float = 0.0, fail_threshold: int = 3,
                 cooldown: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = deadline
        self.fail_threshold = max(1, fail_threshold)
        self.cooldown = cooldown
        self.clock = clock
        self._mu = threading.Lock()
        self._state = CLOSED
        self._fails = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.opens_total = 0
        self.refused_total = 0
        # invoked (outside the lock) on each CLOSED/PROBING -> OPEN
        # transition; BreakerBank.arm_notices wires the noticer push
        self.on_open: Optional[Callable[[], None]] = None

    @property
    def enabled(self) -> bool:
        return self.deadline > 0

    @property
    def state(self) -> str:
        with self._mu:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> str:
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.cooldown:
            self._state = PROBING
            self._probe_out = False
        return self._state

    def allow(self) -> bool:
        """May a call be attempted now?  In PROBING exactly one caller
        gets True per cooldown window (the probe); everyone else is
        refused until it reports back."""
        if not self.enabled:
            return True
        with self._mu:
            st = self._effective_state_locked()
            if st == CLOSED:
                return True
            if st == PROBING and not self._probe_out:
                self._probe_out = True
                return True
            self.refused_total += 1
            return False

    def record(self, ok: bool, elapsed: float = 0.0):
        """Report a completed call.  ``ok`` means it succeeded AND beat
        the deadline; callers that measured a slow success pass
        ``ok=False`` via ``elapsed`` (slow == browned out)."""
        if not self.enabled:
            return
        if ok and elapsed > self.deadline:
            ok = False
        opened = False
        with self._mu:
            st = self._effective_state_locked()
            if ok:
                self._state = CLOSED
                self._fails = 0
                self._probe_out = False
                return
            self._fails += 1
            if st == OPEN:
                # straggler: a call that was already in flight when the
                # breaker opened fails late.  It must NOT restart the
                # cooldown (a scatter-gather's stragglers draining over
                # tens of seconds would push the probe — and recovery —
                # out indefinitely) nor inflate opens_total.
                return
            if st == PROBING or self._fails >= self.fail_threshold:
                self.opens_total += 1
                self._state = OPEN
                self._opened_at = self.clock()
                self._probe_out = False
                opened = True
        if opened and self.on_open is not None:
            # outside the lock: the hook must never stall (or deadlock)
            # the RPC path that reported the failure
            try:
                self.on_open()
            except Exception as e:  # noqa: BLE001 — paging is
                # best-effort; breaking is the load-bearing part
                log.warnf("breaker on_open hook failed: %s", e)

    def snapshot(self) -> dict:
        with self._mu:
            return {"state": self._effective_state_locked(),
                    "consecutive_fails": self._fails,
                    "opens_total": self.opens_total,
                    "refused_total": self.refused_total,
                    "deadline_s": self.deadline}


class ShardDegradedError(RuntimeError):
    """A shard's circuit breaker is OPEN: the op was refused fail-fast
    instead of stalling behind a browned-out shard.  Callers treat it
    like any transient store/sink error — the claim and flush ladders
    already retry, and leased keys (orders, fences, procs) age out
    safely."""


# lifecycle methods pass through unguarded: they are not RPCs (close on
# a dead shard must not count as a failure, clone must hand back the
# RAW client for re-wrapping)
_GUARD_PASSTHROUGH = frozenset(("clone", "close", "start_sweeper"))


class ShardGuard:
    """Per-shard health wrapper for the sharded fan-out clients: every
    RPC is breaker-gated (open -> :class:`ShardDegradedError`
    immediately, no wire wait) and timed (a success slower than the
    deadline counts as a brownout failure).  Pure delegation otherwise
    — the guarded client keeps the wrapped client's full surface.

    ``healthy_errors`` are exception types that are legitimate server
    ANSWERS, not shard-health failures (a missing lease, a compacted
    watch): they record success and re-raise."""

    __slots__ = ("_inner", "_breaker", "_idx", "_label", "_healthy",
                 "_cache")

    def __init__(self, inner, breaker: CircuitBreaker, idx: int,
                 healthy_errors=(KeyError,), label: str = "shard"):
        self._inner = inner
        self._breaker = breaker
        self._idx = idx
        self._label = label
        self._healthy = tuple(healthy_errors)
        self._cache: dict = {}

    def __getattr__(self, name):
        cached = self._cache.get(name)
        if cached is not None:
            return cached
        fn = getattr(self._inner, name)
        # generator functions (get_prefix_paged) pass through UNGUARDED:
        # timing generator CREATION would record an instant "success"
        # without touching the wire — a cooldown probe consumed by one
        # would close the breaker with no evidence — and mid-iteration
        # faults can't be attributed to one call anyway
        if not callable(fn) or name in _GUARD_PASSTHROUGH or \
                name.startswith("_") or inspect.isgeneratorfunction(fn):
            return fn
        breaker, idx, label = self._breaker, self._idx, self._label
        healthy = self._healthy

        def guarded(*a, **kw):
            if not breaker.allow():
                raise ShardDegradedError(
                    f"{label} {idx} degraded (breaker open); "
                    f"{name} refused fail-fast")
            t0 = time.monotonic()
            try:
                r = fn(*a, **kw)
            except healthy:
                breaker.record(True, time.monotonic() - t0)
                raise
            except Exception:
                breaker.record(False)
                raise
            breaker.record(True, time.monotonic() - t0)
            return r
        self._cache[name] = guarded
        return guarded


class BreakerBank:
    """Per-shard breakers + degraded-read accounting, shared by the
    sharded store and logsink clients (one definition — the two were
    drifting copies).  ``deadline <= 0`` disables everything: guards()
    hands back the raw clients and snapshot() is empty."""

    def __init__(self, nshards: int, deadline: float,
                 fail_threshold: int = 3, cooldown: float = 1.0,
                 label: str = "shard"):
        self.nshards = nshards
        self.deadline = deadline
        self.label = label
        self.breakers = [
            CircuitBreaker(deadline=deadline,
                           fail_threshold=fail_threshold,
                           cooldown=cooldown)
            for _ in range(nshards)]
        self._degraded = [0] * nshards
        self._mu = threading.Lock()
        self._log_at = 0.0

    @property
    def enabled(self) -> bool:
        return self.deadline > 0 and self.nshards > 1

    def guards(self, raw: List, healthy_errors=(KeyError,)) -> List:
        """Wrap the raw shard clients — or return them untouched when
        the bank is disabled (byte-identical behavior)."""
        if not self.enabled:
            return list(raw)
        return [ShardGuard(s, self.breakers[i], i,
                           healthy_errors=healthy_errors,
                           label=self.label)
                for i, s in enumerate(raw)]

    def note_degraded(self, i: int):
        """A tolerant read skipped shard ``i`` (breaker open): count it
        LOUDLY — a degraded partial result must be visible in metrics
        and logs, never silent."""
        with self._mu:
            self._degraded[i] += 1
        now = time.monotonic()
        if now - self._log_at >= 1.0:          # rate-limited, loud
            self._log_at = now
            log.warnf("%s %d degraded (breaker %s): serving partial "
                      "reads without it", self.label, i,
                      self.breakers[i].state)

    def tolerant(self, i: int, fn, default=None):
        """Wrap a fan thunk for a read that can TOLERATE a missing
        shard: an open breaker yields ``default`` (counted) instead of
        failing the whole scatter-gather."""
        def run():
            try:
                return fn()
            except ShardDegradedError:
                self.note_degraded(i)
                return default
        return run

    def arm_notices(self, store, prefix: str, source: str = "",
                    interval_s: float = 60.0):
        """Push a breaker OPEN transition into the noticer plane: a
        shard browning out should PAGE, not just count.

        Each transition writes a notice key under
        ``<prefix>/noticer/breaker-<label>-<shard>`` which the
        NoticerHost (hosted by the web process) delivers by SMTP/HTTP
        with its usual durable-retry ladder.  Rate-limited per shard
        (``interval_s``) — a flapping breaker pages once a minute, not
        once per open — and written BEST-EFFORT on a background thread
        with a short retry ladder: the write itself may route to the
        very shard that just opened, in which case it lands once the
        probe closes the breaker (the page is late, the metrics gauge
        is the real-time signal).

        ``store`` is any client with ``put`` (typically the sharded
        client that owns this bank); idempotent to call once per bank.
        """
        if not self.enabled:
            return
        slug = self.label.replace(" ", "-")
        last = [0.0] * self.nshards

        def mk(i: int):
            def fire():
                now = time.monotonic()
                if now - last[i] < interval_s:
                    return
                last[i] = now
                snap = self.breakers[i].snapshot()
                key = f"{prefix}/noticer/breaker-{slug}-{i}"
                body = json.dumps({
                    "subject": f"[cronsun] {self.label} {i} circuit "
                               f"OPEN" + (f" ({source})" if source
                                          else ""),
                    "body": f"{self.label} {i} breaker opened "
                            f"(open #{snap['opens_total']}, deadline "
                            f"{snap['deadline_s']}s): consecutive "
                            "failures or brownouts; writes fail fast "
                            "and tolerant reads serve without this "
                            "shard until a cooldown probe succeeds. "
                            "See cronsun_*_shard_breaker_* at "
                            "/v1/metrics."})

                def write():
                    for _ in range(10):
                        try:
                            store.put(key, body)
                            return
                        except Exception:  # noqa: BLE001 — the notice
                            # may route to the open shard; retry as it
                            # heals, give up quietly after the ladder
                            time.sleep(2.0)
                    log.warnf("breaker-open notice for %s %d could not "
                              "be written (store degraded)",
                              self.label, i)
                threading.Thread(target=write, daemon=True,
                                 name=f"breaker-notice-{slug}-{i}"
                                 ).start()
            return fire
        for i, b in enumerate(self.breakers):
            b.on_open = mk(i)

    def snapshot(self) -> List[dict]:
        """Per-shard breaker state + degraded-read counts (rendered at
        /v1/metrics).  Empty when disabled."""
        if not self.enabled:
            return []
        with self._mu:
            degraded = list(self._degraded)
        out = []
        for i, b in enumerate(self.breakers):
            snap = b.snapshot()
            snap["shard"] = i
            snap["degraded_reads_total"] = degraded[i]
            out.append(snap)
        return out
