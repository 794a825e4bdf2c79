"""One retry/backoff schedule for the whole plane.

Before this module the repo carried four hand-rolled copies of the same
exponential ladder — the store client's reconnect loop
(store/remote.py), the agents' record-flush retry slot (node/agent.py),
the noticer's delivery queue (noticer.py), and the publisher's chunk
retry (sched/publisher.py) — each with its own base/cap constants and
its own off-by-one convention.  Ladders that drift silently are a
robustness hazard: a base that shrinks 2x halves outage coverage, a cap
that grows 2x doubles recovery latency, and nothing fails until a real
outage measures it.  This module is the single definition; the chaos
bench and a pinning unit test (tests/test_chaos.py) keep every consumer
on the published schedule.

Schedules are DETERMINISTIC by default (``jitter=0``): the fault drills
must replay byte-identically under a fixed seed.  Consumers that fan
out across a fleet (reconnect herds) can opt into jitter; the RNG is
then seeded explicitly so a drill's schedule is still reproducible.
"""

from __future__ import annotations

import random
import time
from typing import Iterator, Optional


class Backoff:
    """Exponential backoff schedule: ``delay(n)`` for the n-th
    consecutive failure (1-based) is ``min(cap, base * factor**(n-1))``,
    plus up to ``jitter`` fraction of that value when jitter is enabled.

    Instances are immutable descriptions of a schedule; per-retry state
    (the attempt counter) lives with the caller, which keeps one shared
    instance safe across threads.
    """

    __slots__ = ("base", "cap", "factor", "jitter", "_rng")

    def __init__(self, base: float, cap: float, factor: float = 2.0,
                 jitter: float = 0.0, seed: Optional[int] = None):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError(
                f"bad backoff schedule: base={base} cap={cap} "
                f"factor={factor}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        # explicit seed -> reproducible jitter (the chaos drills); no
        # seed -> process-local randomness for production herd spreading
        self._rng = random.Random(seed) if jitter else None

    def delay(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based: the wait after the
        first failure is ``delay(1) == base``).  The exponent is
        clamped: consumers retry UNBOUNDED (a reconnect loop during an
        hours-long outage reaches attempt counts where a float pow
        raises OverflowError — which would kill the very heal thread
        the ladder exists for), and past ~64 doublings every real
        schedule sits at its cap anyway."""
        if attempt < 1:
            attempt = 1
        d = min(self.cap, self.base * self.factor ** min(attempt - 1, 64))
        if self._rng is not None:
            d += d * self.jitter * self._rng.random()
        return d

    def delays(self, max_attempts: int) -> Iterator[float]:
        """The first ``max_attempts`` delays, in order."""
        for n in range(1, max_attempts + 1):
            yield self.delay(n)

    def sleep(self, attempt: int,
              sleep_fn=time.sleep) -> float:
        """Sleep out retry ``attempt``'s delay; returns the delay."""
        d = self.delay(attempt)
        sleep_fn(d)
        return d


# ---------------------------------------------------------------------------
# The plane's published ladders.  These constants are LOAD-BEARING:
# tests/test_chaos.py pins the exact schedules so a consumer can't
# drift away silently.  Change them here, with the test, on purpose.
# ---------------------------------------------------------------------------

#: Store client reconnect (store/remote.py _heal): fast first probe, a
#: couple of doublings, then steady 2 s — a dead store is repolled
#: briskly without a thundering reconnect herd.
RECONNECT = Backoff(base=0.2, cap=2.0)

#: Record-flush retry slot (node/agent.py): 0.5 s .. 10 s between
#: attempts.  With rec_flush_max_fails=30 this covers a ~4-5 minute
#: sink outage before a batch is declared lost.
REC_FLUSH = Backoff(base=0.5, cap=10.0)

#: Noticer delivery retries (noticer.py): alerts re-send briskly at
#: first, then settle to one attempt per 30 s for long SMTP outages.
NOTICER = Backoff(base=0.5, cap=30.0)

#: Publish chunk retries (sched/publisher.py): 4 attempts inside one
#: window's budget — 0.2/0.4/0.8/1.6 s — before the window records a
#: hole and the cursor rewinds.
PUBLISH = Backoff(base=0.2, cap=2.0)
PUBLISH_ATTEMPTS = 4

#: ctl ``logs --follow`` stream reconnects (bin/ctl.py): a transient
#: SSE disconnect resumes from the follower's cursor on 0.5 s .. 30 s,
#: jittered up to 50% — a fleet of followers dropped by one replica
#: restart must not reconnect as a herd.  Unseeded on purpose: nothing
#: replays this ladder, and herd spreading wants real randomness.
SSE_RECONNECT = Backoff(base=0.5, cap=30.0, jitter=0.5)
