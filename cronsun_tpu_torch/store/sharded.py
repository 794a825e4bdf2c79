"""Horizontal store sharding: a routing client over N ``stored`` shards.

Striping scales the store WITHIN one process; every RPC still
funneled through one ``stored`` — one WAL, one event plane, one accept
loop — and aggregate drain plateaued there (~20.6k orders/s at 8
agents).  This module partitions the KEYSPACE across N independent
store processes, each a perfectly ordinary ``stored`` (same wire
protocol, same WAL + snapshot checkpoint format, just a smaller
keyspace), and gives every component a drop-in client with the exact
MemStore/RemoteStore surface.

Routing — deterministic, shared with ``native/agentd.cc`` bit-for-bit:

- :func:`shard_token` extracts a ROUTING TOKEN from the key so related
  keys co-locate by key design (the pjit partitioning move: shard by
  key, keep hot paths local):

  * ``lock/<job>/<sec>``, ``proc/<node>/<grp>/<job>/<pid>``,
    ``cmd/<grp>/<job>``, ``once/<grp>/<job>``, ``phase/<grp>/<job>/…``
    all route by the JOB — a fire's fence, proc key, and job document
    live on ONE shard, so the per-item fence+proc claim stays atomic
    and the bundle-resolve ``get_many`` groups exactly like the claims
    that follow it;
  * ``dispatch/<node>/…`` and ``node/<id>`` route by the NODE — an
    agent's order stream and liveness key live on one shard;
  * everything else routes by the full key.

- :func:`fnv1a` (64-bit FNV-1a over UTF-8) maps the token to a shard.
  Python's builtin ``hash`` (the intra-process stripe hash) is salted
  per process and can't agree across the fleet; FNV-1a is the same
  scheme made deterministic.

A coalesced (node, second) bundle's items therefore PARTITION by job
hash: :meth:`ShardedStore.claim_bundle` splits the bundle into one
sub-bundle per shard and fans them out CONCURRENTLY (wall-clock is the
slowest shard, not the sum), with the reservation-key delete ordered
LAST — a crash mid-bundle leaves the leased order key for redelivery
instead of losing members, exactly the chunked-publish contract.  The
(job, second) fences keep their global exactly-once meaning because a
fence key routes the same everywhere, whoever claims it.

Watches open one stream per shard and merge into a single
:class:`ShardedWatcher`: per-shard ordering is preserved (each shard's
events arrive in its revision order), cross-shard interleaving is
arbitrary (there is no global revision), and the merged stream carries
a PER-SHARD REVISION VECTOR (:meth:`ShardedWatcher.rev_vector`) for
resume.  Any shard's stream overflowing makes the merged stream lossy
— buffered tail first, then :class:`WatchLost` — the same re-list
contract consumers already implement.

Leases are granted on EVERY shard and exposed as one composite id; the
registry translating composite→per-shard ids is shared with
:meth:`ShardedStore.clone` children, so a lease granted on the main
client works from a publisher lane.  Composite ids are meaningful only
within the granting client (and its clones) — the server-side leases
themselves expire by TTL exactly as before.

The shard topology is pinned by a SHARD-MAP key on shard 0
(``<prefix>/shardmap``): the first client publishes ``{"n": N,
"hash": HASH_SCHEME}``, every later client verifies it, and a client
configured with a different shard count refuses to start instead of
silently scattering the keyspace under a second topology.

With ONE shard every operation passes through verbatim — no split, no
lease translation, no shard-map write: the 1-shard configuration is
behaviorally identical to a plain client.

Copy of ``cronsun_tpu/store/sharded.py``; the only difference: comments that dated a
behaviour by the JAX package's history now say what it is.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from .. import log
from ..core.breaker import BreakerBank, ShardDegradedError  # noqa: F401
# (ShardDegradedError re-exported: it is the error sharded-store
# callers catch around fail-fast claims)
from .memstore import CompactedError, Event, KV, LossyEventStream, \
    WatchLost

HASH_SCHEME = "fnv1a-token-v1"

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def fnv1a(s: str) -> int:
    """64-bit FNV-1a over UTF-8 bytes — deterministic across processes
    and languages (native/agentd.cc carries the same constants)."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def shard_token(key: str, prefix: str = "/cronsun") -> str:
    """Routing token for ``key`` (see module docstring for the
    co-location design).  Keys outside the keyspace prefix route by
    their full text — always deterministic, never an error."""
    pfx = prefix + "/"
    if not key.startswith(pfx):
        return key
    seg = key[len(pfx):].split("/")
    comp = seg[0]
    if comp in ("dispatch", "node") and len(seg) >= 2 and seg[1]:
        return "n:" + seg[1]
    if comp == "lock":
        if len(seg) >= 3 and seg[1] == "alone" and seg[2]:
            return "j:" + seg[2]
        if len(seg) >= 2 and seg[1]:
            return "j:" + seg[1]
    if comp == "proc" and len(seg) >= 4 and seg[3]:
        return "j:" + seg[3]
    if comp in ("cmd", "once", "phase") and len(seg) >= 3 and seg[2]:
        return "j:" + seg[2]
    return key


def shard_index(key: str, nshards: int, prefix: str = "/cronsun") -> int:
    if nshards <= 1:
        return 0
    if key == prefix + "/shardmap":
        return 0            # the topology pin lives on shard 0 by fiat
    return fnv1a(shard_token(key, prefix)) % nshards


def prefix_shard_token(pfx_str: str, prefix: str = "/cronsun") -> Optional[str]:
    """Routing token shared by EVERY key under ``pfx_str``, or None when
    keys under it can hash to different shards.  A segment counts only
    when the prefix CLOSES it with a '/' — ``…/dispatch/A`` also matches
    node "AB", so only ``…/dispatch/A/`` pins to token "n:A".  Lets
    prefix ops (watch / get_prefix / count_prefix / delete_prefix) route
    to ONE shard instead of fanning N ways: an agent's dispatch watch is
    one stream, not N-1 idle ones."""
    pfx = prefix + "/"
    if not pfx_str.startswith(pfx):
        return None
    seg = pfx_str[len(pfx):].split("/")

    def closed(i):              # segment i is complete (a '/' follows)
        return i < len(seg) - 1 and seg[i]

    comp = seg[0]
    if comp in ("dispatch", "node") and closed(1):
        return "n:" + seg[1]
    if comp == "lock":
        if closed(1) and seg[1] == "alone":
            return "j:" + seg[2] if closed(2) else None
        if closed(1):
            return "j:" + seg[1]
        return None
    if comp == "proc" and closed(3):
        return "j:" + seg[3]
    if comp in ("cmd", "once", "phase") and closed(2):
        return "j:" + seg[2]
    return None


def shard_map_key(prefix: str = "/cronsun") -> str:
    """The topology pin.  Lives on shard 0 BY FIAT (not by hash): a
    client must be able to read it knowing only the shard list."""
    return f"{prefix}/shardmap"


def breaker_env_deadline() -> float:
    """Per-shard RPC deadline from the environment; 0 disables the
    breaker (the default — single-host deployments and the tier-1
    suite see no behavior change)."""
    try:
        return float(os.environ.get("CRONSUN_SHARD_DEADLINE_S", "0") or 0)
    except ValueError:
        return 0.0


# server answers that are NOT shard-health failures: the RPC completed,
# the server just said no (missing lease, compacted watch history, a
# cancelled stream) — only transport errors and deadline overruns count
_HEALTHY_ERRORS = (KeyError, CompactedError, WatchLost)


class ShardedWatcher(LossyEventStream):
    """Merged view over one watch stream per shard.

    One forwarder thread per child drains that shard's stream into the
    shared queue: events from one shard arrive in that shard's revision
    order (the per-shard contract), cross-shard interleaving is
    arbitrary.  A child raising :class:`WatchLost` marks the MERGED
    stream lost — buffered tail first, then WatchLost, the standard
    re-list contract.  :meth:`rev_vector` snapshots each child's resume
    point; pass it back as ``start_rev`` to resume every shard's stream
    exactly where this one left off."""

    def __init__(self, prefix: str, children: Sequence, events: str = "",
                 shard_ids: Optional[Sequence[int]] = None,
                 nshards: int = 0,
                 start_revs: Optional[Sequence[int]] = None):
        super().__init__(prefix)
        self.events = events
        self._children = list(children)
        # a token-pinned prefix opens fewer streams than there are
        # shards; shard_ids maps child position -> GLOBAL shard index
        # so rev_vector() keeps the full-length resume contract
        self._ids = (list(shard_ids) if shard_ids is not None
                     else list(range(len(self._children))))
        # seed the resume tracker from the vector this watch resumed
        # at: a shard that delivers nothing before the next
        # rev_vector() snapshot must report ITS resume point back, not
        # regress to 0 ("resume live") and silently skip its backlog
        if start_revs is not None:
            self._revs = [rv - 1 if rv else 0 for rv in start_revs]
        else:
            self._revs = [0] * max(nshards, len(self._children))
        self._halted = False
        self._threads = []
        for i, ch in enumerate(self._children):
            t = threading.Thread(target=self._forward,
                                 args=(self._ids[i], ch),
                                 daemon=True, name="shard-watch-fwd")
            t.start()
            self._threads.append(t)

    def _halt(self):
        """One shard lost the stream: stop EVERY forwarder so the
        merged queue stops refilling.  The single-stream WatchLost
        guarantee ("buffered tail, then raise — never a silent starve")
        rests on the producer going quiet after loss; with live shards
        still feeding the queue, a busy consumer's drain() would keep
        returning non-empty batches and never surface the loss."""
        self.lost = True
        self._halted = True
        for ch in self._children:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — already dead
                pass

    def _forward(self, idx, child):
        while not self._closed and not self._halted:
            try:
                ev = child.get(timeout=0.25)
            except WatchLost:
                self._halt()
                self._q.put(None)
                return
            if ev is not None:
                self._q.put((idx, ev))
            elif getattr(child, "_closed", False):
                if child.lost:
                    self._halt()
                    self._q.put(None)
                return

    # the queue holds (shard_idx, event) so the per-shard resume
    # revision advances at CONSUME time — rev_vector() reflects what
    # the consumer has actually seen, not what forwarders buffered
    def get(self, timeout=None):
        ev = super().get(timeout=timeout)
        if ev is None:
            return None
        idx, ev = ev
        rev = getattr(ev.kv, "mod_rev", 0)
        if rev > self._revs[idx]:
            self._revs[idx] = rev
        return ev

    def drain(self) -> List[Event]:
        out = []
        for idx, ev in super().drain():
            rev = getattr(ev.kv, "mod_rev", 0)
            if rev > self._revs[idx]:
                self._revs[idx] = rev
            out.append(ev)
        return out

    def rev_vector(self) -> List[int]:
        """Per-shard RESUME revisions: pass this vector back as
        ``start_rev`` to resume every shard after the last event this
        consumer saw (inclusive-replay semantics, so entries are
        last_seen + 1; 0 where the shard has delivered nothing —
        resume live)."""
        return [rv + 1 if rv else 0 for rv in self._revs]

    def close(self):
        if self._closed:
            return
        self._closed = True
        for ch in self._children:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._q.put(None)


class ShardedStore:
    """Routing client over N store shards with the full
    MemStore/RemoteStore surface — scheduler, agents, web, and noticer
    run unchanged against it.

    ``shards`` is a list of store clients (RemoteStore per shard in
    production; MemStore works too, which is what the conformance
    tests use).  Single-key ops route directly; multi-key ops split
    per shard and fan out concurrently on a small pool; claims keep
    their per-item atomicity on the fence's shard (see module
    docstring for the bundle ordering contract)."""

    def __init__(self, shards: Sequence, prefix: str = "/cronsun",
                 verify_map: bool = True, _parent: "ShardedStore" = None,
                 shard_deadline: Optional[float] = None,
                 breaker_fails: int = 3, breaker_cooldown: float = 1.0):
        if not shards:
            raise ValueError("ShardedStore needs at least one shard")
        self._raw = list(shards)       # unguarded clients (lifecycle)
        self.nshards = len(self._raw)
        self.prefix = prefix
        # per-shard brownout handling: with a deadline configured
        # (param, or CRONSUN_SHARD_DEADLINE_S), each shard client is
        # wrapped in a breaker guard — ops against an OPEN shard fail
        # fast, tolerant reads skip it with a loud shard_degraded
        # count, and the plane's latency is bounded by its healthy
        # shards.  deadline <= 0 (the default) disables everything:
        # self.shards IS self._raw and behavior is byte-identical.
        if shard_deadline is None:
            shard_deadline = breaker_env_deadline()
        self.shard_deadline = shard_deadline
        if _parent is not None:
            # clones (publisher lanes) share the parent's bank: shard
            # health is a property of the SHARD, not of the lane
            # observing it
            self._bank = _parent._bank
        else:
            self._bank = BreakerBank(self.nshards, shard_deadline,
                                     fail_threshold=breaker_fails,
                                     cooldown=breaker_cooldown,
                                     label="store shard")
            # a shard browning out should PAGE, not just count: an
            # OPEN transition writes a (rate-limited) notice key the
            # NoticerHost delivers — routed through this same client,
            # so it lands on a healthy shard immediately or on the
            # broken one as it heals (core/breaker.py arm_notices)
            self._bank.arm_notices(self, prefix)
        self._breakers = self._bank.breakers
        self.shards = self._bank.guards(self._raw,
                                        healthy_errors=_HEALTHY_ERRORS)
        # close() closes only shards this instance opened: a clone()
        # over shard clients with no clone() of their own (MemStore)
        # ALIASES the parent's shards, and closing those would kill the
        # parent's live watchers and WAL mid-flight
        self._owned = [True] * self.nshards
        self._pool = (ThreadPoolExecutor(
            max_workers=max(2, 2 * self.nshards) +
            (2 * self.nshards if shard_deadline > 0 else 0),
            thread_name_prefix="shard-fan") if self.nshards > 1 else None)
        if _parent is not None:
            # clones (publisher lanes) share the composite-lease
            # registry: a lease granted on the main client must work
            # from any lane
            self._lease_mu = _parent._lease_mu
            self._lease_map = _parent._lease_map
            self._lease_ctr = _parent._lease_ctr
        else:
            self._lease_mu = threading.Lock()
            self._lease_map: Dict[int, List[int]] = {}
            self._lease_ctr = itertools.count(1)
        if self.nshards > 1 and verify_map and _parent is None:
            self._pin_shard_map()

    # ---- routing ---------------------------------------------------------

    def _idx(self, key: str) -> int:
        return shard_index(key, self.nshards, self.prefix)

    def _shard(self, key: str):
        return self.shards[self._idx(key)]

    def _prefix_idx(self, pfx_str: str) -> Optional[int]:
        """Shard index when every key under ``pfx_str`` routes there
        (the prefix closes the routing token), else None — prefix ops
        use this to go single-shard instead of fanning N ways."""
        if self.nshards == 1:
            return 0
        tok = prefix_shard_token(pfx_str, self.prefix)
        return None if tok is None else fnv1a(tok) % self.nshards

    def _fan(self, fns):
        """Run thunks concurrently (one per shard touched); re-raises
        the first failure after all complete.  With one thunk — or one
        shard — runs inline."""
        fns = list(fns)
        if len(fns) == 1 or self._pool is None:
            return [fn() for fn in fns]
        futs = [self._pool.submit(fn) for fn in fns]
        out, first_err = [], None
        for f in futs:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 — collected below
                out.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return out

    def _tolerant(self, i: int, fn, default=None):
        """Partial-tolerant fan thunk (core.breaker.BreakerBank): an
        open breaker yields ``default`` (counted loudly) instead of
        failing the scatter-gather."""
        return self._bank.tolerant(i, fn, default=default)

    def breaker_snapshot(self) -> List[dict]:
        """Per-shard breaker state + degraded-read counts (rendered at
        /v1/metrics; the chaos bench reads it too).  Empty when the
        breaker is disabled."""
        return self._bank.snapshot()

    def _pin_shard_map(self):
        key = shard_map_key(self.prefix)
        want = {"n": self.nshards, "hash": HASH_SCHEME}
        s0 = self.shards[0]
        s0.put_if_absent(key, json.dumps(want, sort_keys=True))
        kv = s0.get(key)
        try:
            got = json.loads(kv.value) if kv else None
        except ValueError:
            got = None
        if not isinstance(got, dict) or got.get("n") != self.nshards \
                or got.get("hash") != HASH_SCHEME:
            raise RuntimeError(
                f"shard-map mismatch at {key}: store set was laid out "
                f"as {got!r}, this client is configured for {want!r} — "
                "refusing to scatter one keyspace under two topologies")

    # ---- leases ----------------------------------------------------------

    def _xlease(self, lease: int, idx: int) -> int:
        """Composite→per-shard lease id for shard ``idx``."""
        if not lease or self.nshards == 1:
            return lease
        with self._lease_mu:
            ids = self._lease_map.get(lease)
        if ids is None:
            raise KeyError(f"lease {lease} not found")
        return ids[idx]

    def grant(self, ttl: float) -> int:
        if self.nshards == 1:
            return self.shards[0].grant(ttl)
        # sequential with rollback (the C++ mirror's shape): a later
        # shard failing must not strand live TTL leases on the earlier
        # ones — callers retry grants in a loop, and each stranded set
        # would pin its keys for the full TTL.
        #
        # BROWNOUT tolerance: a shard whose breaker is OPEN gets the
        # server-impossible -1 sentinel as its leg instead of failing
        # the WHOLE composite — one browned-out shard must not take
        # every healthy shard's lease plane (fences, proc registry,
        # node liveness) down with it.  Writes that would use the -1
        # leg are refused by the open breaker anyway; once the shard
        # heals, -1 is rejected LOUDLY server-side and the caller's
        # rotate/regrant ladder mints a full composite (the
        # cross-shard lease contract — never silently unleased).
        ids: List[int] = []
        degraded = 0
        try:
            for s in self.shards:
                try:
                    ids.append(s.grant(ttl))
                except ShardDegradedError:
                    ids.append(-1)
                    degraded += 1
        except BaseException:
            for s, i in zip(self.shards, ids):
                if i == -1:
                    continue
                try:
                    s.revoke(i)
                except Exception:  # noqa: BLE001 — already failing
                    pass
            raise
        if degraded == self.nshards:
            raise ShardDegradedError(
                "every shard's breaker is open; no lease granted")
        with self._lease_mu:
            cid = next(self._lease_ctr)
            self._lease_map[cid] = ids
        return cid

    def keepalive(self, lease_id: int) -> bool:
        if self.nshards == 1:
            return self.shards[0].keepalive(lease_id)
        with self._lease_mu:
            ids = self._lease_map.get(lease_id)
        if ids is None:
            return False
        # a -1 leg (granted while that shard's breaker was open) has
        # nothing to keep alive; a leg whose shard is degraded NOW is
        # UNKNOWN — treated alive, because the caller's reaction to
        # False (revoke + regrant + re-put every key) would fail
        # against the same open breaker and thrash the healthy shards.
        # The degraded shard's leg may expire server-side meanwhile:
        # that shard's keys are its own bounded brownout loss, exactly
        # the fail-fast contract's blast radius.
        def one(s, i):
            if i == -1:
                return True
            try:
                return s.keepalive(i)
            except ShardDegradedError:
                return True
        oks = self._fan([lambda s=s, i=i: one(s, i)
                         for s, i in zip(self.shards, ids)])
        return all(oks)

    def revoke(self, lease_id: int) -> bool:
        if self.nshards == 1:
            return self.shards[0].revoke(lease_id)
        with self._lease_mu:
            ids = self._lease_map.pop(lease_id, None)
        if ids is None:
            return False

        def one(s, i):
            if i == -1:
                return False
            try:
                return s.revoke(i)
            except ShardDegradedError:
                return False   # leg expires by TTL on the open shard
        oks = self._fan([lambda s=s, i=i: one(s, i)
                         for s, i in zip(self.shards, ids)])
        return any(oks)

    def lease_ttl_remaining(self, lease_id: int) -> Optional[float]:
        if self.nshards == 1:
            return self.shards[0].lease_ttl_remaining(lease_id)
        with self._lease_mu:
            ids = self._lease_map.get(lease_id)
        if ids is None:
            return None
        def one(s, i):
            if i == -1:
                return None    # leg never granted (degraded shard)
            try:
                return s.lease_ttl_remaining(i)
            except ShardDegradedError:
                return None
        outs = self._fan([lambda s=s, i=i: one(s, i)
                          for s, i in zip(self.shards, ids)])
        live = [o for o in outs if o is not None]
        return min(live) if len(live) == len(outs) else None

    # ---- KV --------------------------------------------------------------

    def put(self, key: str, value: str, lease: int = 0) -> int:
        i = self._idx(key)
        return self.shards[i].put(key, value, lease=self._xlease(lease, i))

    def put_many(self, items, lease: int = 0) -> int:
        items = list(items)
        if self.nshards == 1:
            return self.shards[0].put_many(items, lease=lease)
        groups: Dict[int, list] = {}
        for it in items:
            groups.setdefault(self._idx(it[0]), []).append(it)
        revs = self._fan([
            lambda i=i, g=g: self.shards[i].put_many(
                g, lease=self._xlease(lease, i))
            for i, g in groups.items()])
        return max(revs) if revs else 0

    def get(self, key: str) -> Optional[KV]:
        return self._shard(key).get(key)

    def get_many(self, keys) -> List[Optional[KV]]:
        keys = list(keys)
        if self.nshards == 1:
            return self.shards[0].get_many(keys)
        groups: Dict[int, List[int]] = {}
        for pos, k in enumerate(keys):
            groups.setdefault(self._idx(k), []).append(pos)
        parts = self._fan([
            lambda i=i, ps=ps: self.shards[i].get_many(
                [keys[p] for p in ps])
            for i, ps in groups.items()])
        out: List[Optional[KV]] = [None] * len(keys)
        for ps, part in zip(groups.values(), parts):
            for p, kv in zip(ps, part):
                out[p] = kv
        return out

    def get_prefix(self, prefix: str) -> List[KV]:
        # STRICT: a breaker-open shard fails the whole scan fast (still
        # bounded latency — an error, not a stall).  Consumers that
        # diff a listing against local state and treat missing keys as
        # DELETIONS (the scheduler's resync, group scrubs) must never
        # silently receive a partial result; dashboards that can
        # tolerate one opt in via get_prefix_degraded.
        pi = self._prefix_idx(prefix)
        if pi is not None:
            return self.shards[pi].get_prefix(prefix)
        parts = self._fan([lambda s=s: s.get_prefix(prefix)
                           for s in self.shards])
        hits = [kv for part in parts for kv in part]
        hits.sort(key=lambda kv: kv.key)
        return hits

    def get_prefix_degraded(self, prefix: str) -> List[KV]:
        """Partial-tolerant prefix scan for DASHBOARD reads: a
        breaker-open shard's keys are simply absent, counted loudly as
        shard_degraded — one browned-out shard costs its own keys, not
        the whole view.  Never use where a missing key is interpreted
        as a deletion."""
        pi = self._prefix_idx(prefix)
        if pi is not None:
            run = self._tolerant(
                pi, lambda: self.shards[pi].get_prefix(prefix),
                default=[])
            return run()
        parts = self._fan([
            self._tolerant(i, lambda s=s: s.get_prefix(prefix))
            for i, s in enumerate(self.shards)])
        hits = [kv for part in parts if part for kv in part]
        hits.sort(key=lambda kv: kv.key)
        return hits

    def get_prefix_page(self, prefix: str, start_after: str = "",
                        limit: int = 50_000) -> List[KV]:
        pi = self._prefix_idx(prefix)
        if pi is not None:
            return self.shards[pi].get_prefix_page(prefix, start_after,
                                                   limit)
        import heapq
        parts = self._fan([
            lambda s=s: s.get_prefix_page(prefix, start_after, limit)
            for s in self.shards])
        return heapq.nsmallest(max(1, limit),
                               (kv for part in parts for kv in part),
                               key=lambda kv: kv.key)

    def get_prefix_paged(self, prefix: str, page: int = 50_000):
        # per-shard cursors: each shard's stream is already sorted, so
        # paging every shard independently and merging ships each key
        # exactly once (one global cursor advances only ~page/N per
        # shard per round, re-fetching the rest up to N times on the
        # scheduler's cold-load path)
        page = max(1, page)

        def shard_stream(s):
            if hasattr(s, "get_prefix_paged"):   # keeps RemoteStore's
                return s.get_prefix_paged(prefix, page)  # old-server fallback

            def gen():
                after = ""
                while True:
                    kvs = s.get_prefix_page(prefix, after, page)
                    yield from kvs
                    if len(kvs) < page:
                        return
                    after = kvs[-1].key
            return gen()

        pi = self._prefix_idx(prefix)
        if pi is not None:
            yield from shard_stream(self.shards[pi])
            return
        import heapq
        yield from heapq.merge(*(shard_stream(s) for s in self.shards),
                               key=lambda kv: kv.key)

    def count_prefix(self, prefix: str) -> int:
        pi = self._prefix_idx(prefix)
        if pi is not None:
            return self.shards[pi].count_prefix(prefix)
        return sum(self._fan([lambda s=s: s.count_prefix(prefix)
                              for s in self.shards]))

    def count_prefix_degraded(self, prefix: str) -> int:
        """Partial-tolerant count (see get_prefix_degraded): an open
        shard contributes 0, counted loudly."""
        pi = self._prefix_idx(prefix)
        if pi is not None:
            return self._tolerant(
                pi, lambda: self.shards[pi].count_prefix(prefix),
                default=0)()
        return sum(self._fan([
            self._tolerant(i, lambda s=s: s.count_prefix(prefix),
                           default=0)
            for i, s in enumerate(self.shards)]))

    def delete(self, key: str) -> bool:
        return self._shard(key).delete(key)

    def delete_prefix(self, prefix: str) -> int:
        pi = self._prefix_idx(prefix)
        if pi is not None:
            return self.shards[pi].delete_prefix(prefix)
        return sum(self._fan([lambda s=s: s.delete_prefix(prefix)
                              for s in self.shards]))

    def delete_many(self, keys) -> int:
        keys = list(keys)
        if self.nshards == 1:
            return self.shards[0].delete_many(keys)
        groups: Dict[int, list] = {}
        for k in keys:
            groups.setdefault(self._idx(k), []).append(k)
        return sum(self._fan([
            lambda i=i, g=g: self.shards[i].delete_many(g)
            for i, g in groups.items()]))

    # ---- txns ------------------------------------------------------------

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        i = self._idx(key)
        return self.shards[i].put_if_absent(
            key, value, lease=self._xlease(lease, i))

    def put_if_mod_rev(self, key: str, value: str, mod_rev: int,
                       lease: int = 0) -> bool:
        i = self._idx(key)
        return self.shards[i].put_if_mod_rev(
            key, value, mod_rev, lease=self._xlease(lease, i))

    # ---- claims ----------------------------------------------------------
    #
    # Per-item atomicity (fence + co-located proc) happens on the
    # FENCE's shard; a proc or order key that hashes elsewhere — rare
    # by key design, see module docstring — is applied around it:
    # remote proc puts for winners first, the order-key release LAST,
    # so a failure mid-way leaves the leased reservation for
    # redelivery and never a consumed order with unapplied members.

    def claim(self, fence_key: str, fence_val: str, fence_lease: int = 0,
              order_key: str = "", proc_key: str = "", proc_val: str = "",
              proc_lease: int = 0) -> bool:
        fi = self._idx(fence_key)
        order_local = bool(order_key) and self._idx(order_key) == fi
        proc_local = bool(proc_key) and self._idx(proc_key) == fi
        won = self.shards[fi].claim(
            fence_key, fence_val, self._xlease(fence_lease, fi),
            order_key if order_local else "",
            proc_key if proc_local else "",
            proc_val if proc_local else "",
            self._xlease(proc_lease, fi) if proc_local else 0)
        if won and proc_key and not proc_local:
            pi = self._idx(proc_key)
            self.shards[pi].put(proc_key, proc_val,
                                lease=self._xlease(proc_lease, pi))
        if order_key and not order_local:
            self._shard(order_key).delete(order_key)
        return won

    def claim_many(self, items, fence_lease: int = 0,
                   proc_lease: int = 0) -> List[bool]:
        items = [list(it) for it in items]
        if self.nshards == 1:
            return self.shards[0].claim_many(items, fence_lease,
                                             proc_lease)
        # split per fence shard; strip keys that hash elsewhere (they
        # are applied around the claim, below)
        groups: Dict[int, List[Tuple[int, list]]] = {}
        out: List[bool] = [False] * len(items)
        for pos, it in enumerate(items):
            if len(it) < 5:
                continue       # malformed: per-item False, like memstore
            fi = self._idx(it[0])
            sub = list(it)
            if sub[2] and self._idx(sub[2]) != fi:
                sub[2] = ""
            if sub[3] and self._idx(sub[3]) != fi:
                sub[3] = sub[4] = ""
            groups.setdefault(fi, []).append((pos, sub))
        parts = self._fan([
            lambda i=i, g=g: self.shards[i].claim_many(
                [sub for _p, sub in g],
                self._xlease(fence_lease, i),
                self._xlease(proc_lease, i))
            for i, g in groups.items()])
        proc_puts: Dict[int, list] = {}
        order_dels: Dict[int, list] = {}
        for (i, g), wins in zip(groups.items(), parts):
            for (pos, _sub), won in zip(g, wins):
                out[pos] = won
                it = items[pos]
                if it[2] and self._idx(it[2]) != i:
                    order_dels.setdefault(self._idx(it[2]),
                                          []).append(it[2])
                if won and it[3] and self._idx(it[3]) != i:
                    proc_puts.setdefault(self._idx(it[3]),
                                         []).append((it[3], it[4]))
        if proc_puts:
            self._fan([lambda i=i, ps=ps: self.shards[i].put_many(
                ps, lease=self._xlease(proc_lease, i))
                for i, ps in proc_puts.items()])
        if order_dels:
            self._fan([lambda i=i, ks=ks: self.shards[i].delete_many(ks)
                       for i, ks in order_dels.items()])
        return out

    def _split_bundle(self, order_key: str, items):
        """One bundle -> per-shard sub-bundles.  Returns (groups, oi,
        stripped) where groups maps shard -> [(item_pos, sub_item)],
        ``oi`` is the order key's shard (None without one), and
        ``stripped`` holds (pos, proc_key, proc_val) for proc keys that
        hash off their fence's shard — removed from the claim and, for
        winners, applied as a routed put AFTER it (the claim/claim_many
        contract: a won fence never silently loses its proc
        registration; by token design this edge is structurally rare)."""
        groups: Dict[int, List[Tuple[int, list]]] = {}
        stripped: List[Tuple[int, str, str]] = []
        for pos, it in enumerate(items):
            it = list(it)
            if len(it) < 4:
                # malformed items must still yield per-item False from
                # SOME shard — route them with the bundle's order key
                # (or shard 0) so the win-list length is preserved
                anchor = self._idx(order_key) if order_key else 0
                groups.setdefault(anchor, []).append((pos, it))
                continue
            fi = self._idx(it[0])
            if it[2] and self._idx(it[2]) != fi:
                stripped.append((pos, it[2], it[3]))
                it[2] = it[3] = ""
            groups.setdefault(fi, []).append((pos, it))
        oi = self._idx(order_key) if order_key else None
        return groups, oi, stripped

    def _put_stripped_procs(self, stripped, wins, proc_lease: int):
        """Routed puts for winners whose proc key hashed off the fence
        shard (post-claim, like claim()'s remote-proc path — the key is
        leased, so a crash here ages out instead of leaking)."""
        puts: Dict[int, list] = {}
        for pos, pk, pv in stripped:
            if wins[pos]:
                puts.setdefault(self._idx(pk), []).append((pk, pv))
        if puts:
            self._fan([lambda i=i, ps=ps: self.shards[i].put_many(
                ps, lease=self._xlease(proc_lease, i))
                for i, ps in puts.items()])

    def claim_bundle(self, order_key: str, items, fence_lease: int = 0,
                     proc_lease: int = 0) -> List[bool]:
        items = [list(it) for it in items]
        if self.nshards == 1:
            return self.shards[0].claim_bundle(order_key, items,
                                               fence_lease, proc_lease)
        groups, oi, stripped = self._split_bundle(order_key, items)
        out: List[bool] = [False] * len(items)

        def run(i, g, ok):
            wins = self.shards[i].claim_bundle(
                ok, [sub for _p, sub in g],
                self._xlease(fence_lease, i),
                self._xlease(proc_lease, i))
            for (pos, _sub), won in zip(g, wins):
                out[pos] = won
        # phase 1: every sub-bundle NOT carrying the reservation key,
        # concurrently; phase 2: the reservation release (the order
        # shard's sub-bundle, or a bare empty-bundle release) — LAST,
        # so a phase-1 failure leaves the leased key for redelivery
        self._fan([lambda i=i, g=g: run(i, g, "")
                   for i, g in groups.items() if i != oi])
        if oi is not None:
            if oi in groups:
                run(oi, groups[oi], order_key)
            else:
                self.shards[oi].claim_bundle(
                    order_key, [], self._xlease(fence_lease, oi),
                    self._xlease(proc_lease, oi))
        if stripped:
            self._put_stripped_procs(stripped, out, proc_lease)
        return out

    def claim_bundle_many(self, bundles, fence_lease: int = 0,
                          proc_lease: int = 0) -> List[List[bool]]:
        if self.nshards == 1:
            return self.shards[0].claim_bundle_many(list(bundles),
                                                    fence_lease,
                                                    proc_lease)
        out: List[List[bool]] = []
        # two per-shard claim_bundle_many waves over the WHOLE backlog:
        # wave 1 carries every order-less sub-bundle, wave 2 carries
        # the reservation releases — batching preserved, release-last
        # ordering preserved
        wave1: Dict[int, list] = {}
        wave2: Dict[int, list] = {}
        fills: List[Optional[Tuple[List[bool], list]]] = []
        strips: List[Tuple[List[bool], list]] = []
        for b in bundles:
            if len(b) < 2 or not isinstance(b[1], (list, tuple)):
                out.append([])      # malformed bundle: [] without abort
                fills.append(None)
                continue
            order_key, items = b[0], [list(it) for it in b[1]]
            wins: List[bool] = [False] * len(items)
            out.append(wins)
            groups, oi, stripped = self._split_bundle(order_key, items)
            if stripped:
                strips.append((wins, stripped))
            fills.append((wins, []))
            for i, g in groups.items():
                wave = wave2 if i == oi else wave1
                wave.setdefault(i, []).append(
                    (order_key if i == oi else "",
                     [sub for _p, sub in g]))
                fills[-1][1].append((wave is wave2, i, g))
            if oi is not None and oi not in groups:
                wave2.setdefault(oi, []).append((order_key, []))
                fills[-1][1].append((True, oi, []))

        def run_wave(wave):
            results = self._fan([
                lambda i=i, bs=bs: self.shards[i].claim_bundle_many(
                    bs, self._xlease(fence_lease, i),
                    self._xlease(proc_lease, i))
                for i, bs in wave.items()])
            # distribute each shard's per-sub-bundle win lists back to
            # the originating bundles, in submission order per shard
            cursors = {i: iter(r) for i, r in
                       zip(wave.keys(), results)}
            return cursors

        for is_second in (False, True):
            wave = wave2 if is_second else wave1
            if not wave:
                continue
            cursors = run_wave(wave)
            for fill in fills:
                if fill is None:
                    continue
                wins, placements = fill
                for w2, i, g in placements:
                    if w2 != is_second:
                        continue
                    sub_wins = next(cursors[i])
                    for (pos, _sub), won in zip(g, sub_wins):
                        wins[pos] = won
        for wins, stripped in strips:
            self._put_stripped_procs(stripped, wins, proc_lease)
        return out

    # ---- watch -----------------------------------------------------------

    def watch(self, prefix: str, start_rev=0, events: str = ""):
        if self.nshards == 1:
            return self.shards[0].watch(prefix, start_rev=start_rev or 0,
                                        events=events)
        if isinstance(start_rev, (list, tuple)):
            if len(start_rev) != self.nshards:
                raise ValueError(
                    f"revision vector has {len(start_rev)} entries for "
                    f"{self.nshards} shards")
            revs = list(start_rev)
        elif start_rev:
            raise ValueError(
                "a sharded watch resumes from a per-shard revision "
                "vector (ShardedWatcher.rev_vector()), not a scalar")
        else:
            revs = [0] * self.nshards
        # a token-pinned prefix (an agent's dispatch/<node>/ stream)
        # lives on ONE shard: open one stream, not N-1 idle ones; the
        # merged watcher still answers a full-length rev vector
        pi = self._prefix_idx(prefix)
        ids = list(range(self.nshards)) if pi is None else [pi]
        opened = []
        try:
            for i in ids:
                opened.append(self.shards[i].watch(
                    prefix, start_rev=revs[i] or 0, events=events))
        except BaseException:
            for w in opened:
                try:
                    w.close()
                except Exception:  # noqa: BLE001 — already dead
                    pass
            raise
        return ShardedWatcher(prefix, opened, events=events,
                              shard_ids=ids, nshards=self.nshards,
                              start_revs=revs)

    # ---- ops / checkpoint plane -----------------------------------------

    def op_stats(self) -> dict:
        """Per-op stats MERGED across shards (counts/total summed,
        max_ms maxed) — same shape as a single store's."""
        parts = self.op_stats_shards()
        if len(parts) == 1:
            return parts[0]
        merged: Dict[str, dict] = {}
        for part in parts:
            for op, ent in part.items():
                m = merged.setdefault(op, {"count": 0, "total_ms": 0.0,
                                           "max_ms": 0.0})
                m["count"] += ent.get("count", 0)
                m["total_ms"] = round(
                    m["total_ms"] + ent.get("total_ms", 0.0), 3)
                m["max_ms"] = max(m["max_ms"], ent.get("max_ms", 0.0))
        return merged

    def op_stats_shards(self) -> List[dict]:
        """Per-SHARD op stats, shard order — /v1/metrics renders these
        with a ``shard`` label when more than one is present.  A
        degraded shard reports ``{}`` (tolerant: metrics scraping must
        not stall behind a browned-out shard)."""
        return self._fan([
            self._tolerant(i, lambda s=s: s.op_stats(), default={})
            for i, s in enumerate(self.shards)])

    def snapshot(self) -> List[int]:
        """Snapshot every shard (per-shard WAL + snapshot sidecar, the
        single-store format unchanged); returns the per-shard revision vector."""
        if self.nshards == 1:
            return self.shards[0].snapshot()
        return self._fan([lambda s=s: s.snapshot() for s in self.shards])

    def rev(self):
        """Scalar revision only exists for one shard; a sharded store
        returns the per-shard vector (checkpoint consumers that need a
        scalar are disabled on sharded stores)."""
        if self.nshards == 1:
            return self.shards[0].rev()
        return self.rev_vector()

    def rev_vector(self) -> List[int]:
        return self._fan([lambda s=s: s.rev() for s in self.shards])

    # ---- lifecycle -------------------------------------------------------

    def clone(self) -> "ShardedStore":
        """Fresh connections to every shard sharing THIS client's
        composite-lease registry (publisher lanes).  A shard client
        with no clone() of its own (MemStore) is ALIASED — the clone's
        close() must leave it alone, or closing a publisher lane would
        kill the parent's live watchers and WAL."""
        kids = [s.clone() if hasattr(s, "clone") else s
                for s in self._raw]
        c = ShardedStore(kids, prefix=self.prefix, verify_map=False,
                         _parent=self,
                         shard_deadline=self.shard_deadline)
        c._owned = [kid is not s for kid, s in zip(kids, self._raw)]
        return c

    def start_sweeper(self, interval: float = 0.2):
        for s in self.shards:
            s.start_sweeper(interval)

    def close(self):
        for own, s in zip(self._owned, self._raw):
            if not own:
                continue        # aliased parent shard (see clone())
            try:
                s.close()
            except Exception as e:  # noqa: BLE001 — best-effort teardown
                log.warnf("shard close failed: %s", e)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def verify_single_store(store, prefix: str = "/cronsun"):
    """Topology pin for a SINGLE-address client: a stale one-store
    config pointed at shard 0 of a multi-shard layout must refuse
    (it would fence every job on one shard and race the rest of the
    fleet for (job, second) fences), not silently serve.  Read-only —
    an un-sharded set never writes the pin, so its behavior is
    unchanged."""
    key = shard_map_key(prefix)
    kv = store.get(key)
    if kv is None:
        return
    try:
        got = json.loads(kv.value)
    except ValueError:
        got = None
    if not isinstance(got, dict) or got.get("n") != 1:
        raise RuntimeError(
            f"shard-map mismatch at {key}: store set was laid out as "
            f"{got!r}, this client is configured for a single store — "
            "refusing to scatter one keyspace under two topologies")


def connect_sharded(addrs: Sequence[str], prefix: str = "/cronsun",
                    timeout: float = 120.0, token: str = "",
                    sslctx=None, tls_hostname: str = ""):
    """Connect a routing client to a shard set.  One address returns a
    plain RemoteStore (byte-identical single-store behavior); several
    return a ShardedStore that pins/verifies the shard map.

    Each shard entry may be an ``addr1|addr2|addr3`` REPLICA GROUP
    (replication plane, repl/): the shard's client becomes a
    ReplicaGroupStore that discovers the group's leader and rotates on
    leader loss through the breaker/backoff ladders.  A group with an
    empty member ("a|,b", "a||b") refuses HERE, at parse time — an
    empty address would otherwise surface as a confusing dial error
    mid-rotation."""
    from .remote import RemoteStore
    conns = []
    try:
        for addr in addrs:
            if "|" in addr:
                members = [m.strip() for m in addr.split("|")]
                if any(not m for m in members):
                    raise ValueError(
                        f"replica group {addr!r} has an empty member "
                        "(want addr1|addr2|...; no doubled, leading, "
                        "or trailing '|')")
                from ..repl.client import ReplicaGroupStore
                conns.append(ReplicaGroupStore(
                    members, timeout=timeout, token=token,
                    sslctx=sslctx, tls_hostname=tls_hostname))
                continue
            host, _, port = addr.rpartition(":")
            conns.append(RemoteStore(host or "127.0.0.1", int(port),
                                     timeout=timeout, token=token,
                                     sslctx=sslctx,
                                     tls_hostname=tls_hostname))
    except BaseException:
        for c in conns:
            c.close()
        raise
    if len(conns) == 1:
        try:
            verify_single_store(conns[0], prefix)
        except BaseException:
            conns[0].close()
            raise
        return conns[0]
    return ShardedStore(conns, prefix=prefix)
