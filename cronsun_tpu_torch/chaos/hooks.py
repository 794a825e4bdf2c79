"""In-process fault points for the wire clients.

A TCP fault proxy (``cronsun_tpu/chaos/faultproxy.py``, not in this
package) can sever and
slow a pipe, but two failure shapes need the CLIENT's cooperation to
inject precisely:

- ``reply_lost`` — the op APPLIES server-side and the reply vanishes.
  This is the indeterminate shape every degraded ladder (claim
  read-back, idempotency-token re-send) exists for, and the only way to
  produce it deterministically for op K of a run is from inside the
  client, after the server answered.
- ``timeout`` — the op never reaches the wire and the caller sees its
  client's timeout error immediately (no real 10 s wait per injected
  fault, so drills stay fast).

Call sites: ``store/remote.py RemoteStore._call`` (site ``store.rpc``)
and ``logsink/serve.py RemoteJobLogStore._call`` (site ``logsink.rpc``).
The hot-path cost when disarmed is ONE attribute read
(``hooks.armed``); production never arms, and arming refuses unless
``CRONSUN_CHAOS`` is set in the environment — the layer cannot be
switched on by code alone.

Determinism: each rule decides "fire or not" for the k-th matching call
from a 64-bit FNV-1a hash of ``(seed, rule_id, k)`` — no RNG state, no
wall clock — so a drill under a fixed seed injects the same faults at
the same op ordinals every run, across processes and languages.

Copy of ``cronsun_tpu/chaos/hooks.py``; the only difference: comments that dated a
behaviour by the JAX package's history now say what it is.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def det01(seed: int, rule_id: str, k: int) -> float:
    """Deterministic uniform-ish [0, 1) for decision ``k`` of a rule:
    64-bit FNV-1a over the textual triple, finished with a splitmix64
    mix (raw FNV of short, similar strings leaves the HIGH bits — the
    ones a divide-by-2^64 exposes — badly skewed).  Stable across
    processes, platforms and reruns — the drills' reproducibility
    rests on it."""
    h = _FNV_OFFSET
    for b in f"{seed}:{rule_id}:{k}".encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    h = ((h ^ (h >> 30)) * 0xbf58476d1ce4e5b9) & _MASK64
    h = ((h ^ (h >> 27)) * 0x94d049bb133111eb) & _MASK64
    h ^= h >> 31
    return h / float(1 << 64)


class ChaosAction:
    """One injected fault, handed to the call site.  ``pre`` runs before
    the request is sent (timeout faults fail here, delay faults sleep);
    ``post`` runs after a successful reply (reply-lost faults discard it
    here — the op has applied server-side)."""

    __slots__ = ("kind", "ms")

    def __init__(self, kind: str, ms: float = 0.0):
        self.kind = kind
        self.ms = ms

    def pre(self, exc: type, op: str):
        if self.kind == "delay":
            if self.ms > 0:
                time.sleep(self.ms / 1000.0)
        elif self.kind == "timeout":
            raise exc(f"rpc timeout: {op} (chaos)")

    def post(self, exc: type, op: str):
        if self.kind == "reply_lost":
            raise exc(f"connection closed (chaos reply-lost: {op})")


class _Rule:
    __slots__ = ("rule_id", "site", "kind", "ops", "prob", "count",
                 "ms", "seed", "seen", "fired")

    def __init__(self, rule_id, site, kind, ops, prob, count, ms, seed):
        self.rule_id = rule_id
        self.site = site
        self.kind = kind
        self.ops = ops          # None = every op, else a frozenset
        self.prob = prob
        self.count = count      # None = unbounded, else remaining budget
        self.ms = ms
        self.seed = seed
        self.seen = 0           # matching calls observed (decision index)
        self.fired = 0


_KINDS = ("reply_lost", "timeout", "delay")


class ChaosHooks:
    """Process-wide fault-rule registry.  One instance (:data:`hooks`)
    is shared by every wire client in the process."""

    def __init__(self):
        self.armed = False
        self._mu = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        self._next = 0
        self.stats: Dict[str, int] = {}

    @staticmethod
    def _env_enabled() -> bool:
        return os.environ.get("CRONSUN_CHAOS", "") not in ("", "0", "off")

    def arm(self, site: str, kind: str, ops=None, prob: float = 1.0,
            count: Optional[int] = None, ms: float = 0.0,
            seed: int = 0, rule_id: Optional[str] = None) -> str:
        """Install a fault rule.  Refuses unless ``CRONSUN_CHAOS`` is
        set — the production gate.  Returns the rule id (pass to
        :meth:`disarm`)."""
        if not self._env_enabled():
            raise RuntimeError(
                "chaos hooks are env-gated off: set CRONSUN_CHAOS=1 to "
                "enable fault injection in this process")
        if kind not in _KINDS:
            raise ValueError(f"unknown chaos kind {kind!r}")
        if isinstance(ops, str):
            ops = (ops,)
        with self._mu:
            self._next += 1
            rid = rule_id or f"{site}/{kind}/{self._next}"
            rule = _Rule(rid, site, kind,
                         frozenset(ops) if ops else None,
                         prob, count, ms, seed)
            self._rules.setdefault(site, []).append(rule)
            self.armed = True
        return rid

    def disarm(self, rule_id: Optional[str] = None):
        """Remove one rule, or every rule when called without one."""
        with self._mu:
            if rule_id is None:
                self._rules.clear()
            else:
                for site, rules in list(self._rules.items()):
                    rules[:] = [r for r in rules if r.rule_id != rule_id]
                    if not rules:
                        del self._rules[site]
            self.armed = any(self._rules.values())

    def intercept(self, site: str, op: str) -> Optional[ChaosAction]:
        """Call-site entry: the first matching rule that decides to fire
        yields an action (at most one fault per call)."""
        with self._mu:
            rules = self._rules.get(site)
            if not rules:
                return None
            for r in rules:
                if r.ops is not None and op not in r.ops:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                k = r.seen
                r.seen += 1
                if r.prob < 1.0 and det01(r.seed, r.rule_id, k) >= r.prob:
                    continue
                r.fired += 1
                key = f"{site}:{r.kind}"
                self.stats[key] = self.stats.get(key, 0) + 1
                return ChaosAction(r.kind, r.ms)
        return None

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self.stats)

    def reset(self):
        with self._mu:
            self._rules.clear()
            self.stats.clear()
            self.armed = False


#: The process-wide registry the wire clients consult.
hooks = ChaosHooks()
