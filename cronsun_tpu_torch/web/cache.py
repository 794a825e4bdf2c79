"""Revision-vector response cache for the web tier's read endpoints.

A dashboard polls the same handful of shapes (latest view, stat
counters) in a tight loop; the ETag path already reads the result
store's revision — scalar for one sink, a per-shard VECTOR for a
sharded one — on every poll.  This cache keys whole responses (and
their per-shard partial results) on that same token:

- revision unchanged and the client sent the ETag  → 304, no body
- revision unchanged, no/stale client ETag         → cached body,
  zero sink reads beyond the revision
- revision CHANGED                                 → recompute ONLY the
  shards whose vector entry moved; unchanged shards' cached partials
  feed the scatter-gather merge unchanged

Soundness: a shard's cached partial is reused only when its CURRENT
revision equals the revision read just before the partial was computed.
Writes racing the compute bump the revision, so the stale-labeled entry
can never satisfy a later lookup — reuse implies no intervening write,
which implies the partial is exact.

``CRONSUN_WEB_CACHE=off`` (or ``ApiServer(cache_enabled=False)``) is
the rollback switch: every poll recomputes, exactly today's behavior.

Copy of ``cronsun_tpu/web/cache.py``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional


def cache_default() -> bool:
    return os.environ.get("CRONSUN_WEB_CACHE", "").lower() not in (
        "off", "0", "false")


class ResponseCache:
    """Bounded LRU of {key -> (revision vector, per-shard partials,
    merged body)} plus the effectiveness counters the bench and
    /v1/metrics read.  Keys carry every request parameter that shapes
    the body, so two filtered views never satisfy each other."""

    def __init__(self, maxsize: int = 256):
        self._maxsize = max(1, maxsize)
        self._lock = threading.Lock()
        self._ent: OrderedDict = OrderedDict()
        self._stats = {
            "etag_304_total": 0,        # If-None-Match matched: no body
            "body_hits_total": 0,       # unchanged vector: cached body
            "shard_reused_total": 0,    # per-shard partials reused
            "shard_recomputed_total": 0,
            "misses_total": 0,          # no entry for the key at all
        }

    def lookup(self, key) -> Optional[dict]:
        with self._lock:
            ent = self._ent.get(key)
            if ent is not None:
                self._ent.move_to_end(key)
            return ent

    def store(self, key, revs: List[int], parts: list, body):
        with self._lock:
            self._ent[key] = {"revs": revs, "parts": parts, "body": body}
            self._ent.move_to_end(key)
            while len(self._ent) > self._maxsize:
                self._ent.popitem(last=False)

    def bump(self, stat: str, n: int = 1):
        with self._lock:
            self._stats[stat] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._stats)
