"""Machine-checked global invariants.

The system's crash-safety story rests on four properties that every PR
so far proved with bespoke one-off tests; this module states them ONCE,
as code, reusable by the drill harness (``scripts/bench_chaos.py``),
the operator audit (``cronsun-ctl fsck``) and any future scenario
bench:

1. **Exactly-once** — no (job, second) fence executes twice
   (:func:`check_exactly_once` over an execution ledger).
2. **Zero acked-record loss** — every record an agent counted as
   flushed is present in the result store; only records the agent
   LOUDLY dropped (``rec_dropped_total``) may be missing
   (:func:`check_acked_records`).
3. **Clean fixpoint** — after the fleet settles, no leaked dispatch
   reservations, no orphan proc keys, no stuck Alone locks, no
   outstanding publish hole (:func:`check_fixpoint`).
4. **Bounded recovery** — measured by the drills themselves (a time,
   not a scan).

:func:`fsck` is the offline union: structural findings an operator can
run against a live fleet (stale reservations, orphan proc entries,
fences without records, dangling dep completions).  Every checker
returns a list of :class:`Finding`; empty means the invariant holds.

Copy of ``cronsun_tpu/chaos/invariants.py``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..core import Job, Keyspace


@dataclasses.dataclass
class Finding:
    code: str       # machine-matchable: "leaked_reservation", ...
    key: str        # the offending key / identity ("" for aggregates)
    detail: str     # human explanation

    def __str__(self):
        return f"[{self.code}] {self.key}: {self.detail}"


def _scan(store, prefix: str):
    if hasattr(store, "get_prefix_paged"):
        yield from store.get_prefix_paged(prefix)
    else:
        yield from store.get_prefix(prefix)


# ---------------------------------------------------------------------------
# drill-side checks (fed from in-memory drill state)
# ---------------------------------------------------------------------------

def check_exactly_once(
        ledger: Iterable[Tuple[str, int]]) -> List[Finding]:
    """``ledger`` holds one (job_id, scheduled_epoch) entry per
    EXECUTION of an exclusive job, fleet-wide.  Any pair appearing
    twice is a double-fired fence — the invariant every claim ladder
    exists to protect."""
    seen: Dict[Tuple[str, int], int] = {}
    for ent in ledger:
        seen[ent] = seen.get(ent, 0) + 1
    return [
        Finding("exactly_once_violation", f"{j}@{s}",
                f"(job, second) executed {n} times")
        for (j, s), n in sorted(seen.items()) if n > 1]


def check_acked_records(flushed_total: int, dropped_total: int,
                        sink_total: int,
                        allow_unacked_extra: bool = False) -> List[Finding]:
    """Ledger audit for the record plane: the sink must hold EXACTLY
    the records the agents acked as flushed — fewer means acked loss
    (a flush the agent believed and the sink lost), more means a
    duplicate insert (an idempotency-token regression).

    ``allow_unacked_extra`` relaxes the upper bound for kill -9 drills:
    a flush that APPLIED but whose ack died with the agent legitimately
    leaves the sink ahead of the acked count — loss is still a
    violation, surplus is not."""
    out = []
    if sink_total < flushed_total:
        out.append(Finding(
            "acked_record_loss", "",
            f"agents acked {flushed_total} records, sink holds "
            f"{sink_total} ({flushed_total - sink_total} lost)"))
    elif sink_total > flushed_total and not allow_unacked_extra:
        out.append(Finding(
            "duplicate_records", "",
            f"sink holds {sink_total} records for {flushed_total} "
            f"acked flushes ({sink_total - flushed_total} duplicated)"))
    if dropped_total:
        # loud by design (the ladder's declared-lost path), but a drill
        # whose fault window fits the retry budget must not see any
        out.append(Finding(
            "records_dropped", "",
            f"{dropped_total} records declared lost by the flush "
            f"ladder (budget exhausted)"))
    return out


def check_fixpoint(store, ks: Optional[Keyspace] = None) -> List[Finding]:
    """Post-settle convergence: once every published order is consumed
    or expired and every execution has finished, the dispatch plane
    must be EMPTY of state — a leftover key is a leak some crash path
    failed to release.  Purely structural (no time axis — fsck owns
    the in-flight-tolerant variant)."""
    ks = ks or Keyspace()
    out: List[Finding] = []
    for kv in _scan(store, ks.dispatch):
        out.append(Finding(
            "leaked_reservation", kv.key,
            "dispatch order/reservation still present after settle"))
    for kv in _scan(store, ks.proc):
        out.append(Finding(
            "orphan_proc", kv.key,
            "proc entry outlived every execution"))
    for kv in _scan(store, ks.alone_lock):
        out.append(Finding(
            "stuck_alone_lock", kv.key,
            "Alone lifetime lock still held after settle"))
    return out


# ---------------------------------------------------------------------------
# offline audit (cronsun-ctl fsck + the drills' structural pass)
# ---------------------------------------------------------------------------

def _dispatch_epoch(key: str, ks: Keyspace) -> Optional[int]:
    """Scheduled epoch of a dispatch key, any wire format: coalesced
    ``dispatch/<node>/<epoch>`` (or the partitioned scheduler's
    ``<epoch>.<partition>`` form), legacy
    ``dispatch/<node>/<epoch>/<grp>/<job>``, broadcast
    ``dispatch/_all/<epoch>/<grp>/<job>``."""
    seg = key[len(ks.dispatch):].split("/")
    if len(seg) >= 2:
        parsed = Keyspace.split_bundle_epoch(seg[1])
        return parsed[0] if parsed is not None else None
    return None


def fsck(store, sink=None, ks: Optional[Keyspace] = None,
         now: Optional[float] = None,
         stale_order_s: float = 900.0,
         fence_settle_s: float = 60.0) -> List[Finding]:
    """Offline invariant audit against a LIVE fleet (read-only).

    Unlike :func:`check_fixpoint` (a post-settle drill gate), fsck
    tolerates in-flight state: a dispatch key is a finding only once
    its scheduled second is ``stale_order_s`` in the past (the leases
    that should have expired it are minutes, not hours), a proc entry
    only when its job no longer exists.  With a ``sink``, fences are
    cross-checked against execution records (an exclusive job must
    have at least as many records as consumed fences) — using the
    SEPARATE, much shorter ``fence_settle_s`` window: fence keys are
    leased and expire ~``lock_ttl + 60`` (360 s at defaults) after
    their second, so a settle window larger than the fence LIFETIME
    would make the cross-check unable to fire at all, while one
    shorter than the record flush lag would false-positive on every
    in-flight run.  60 s clears the flush ladder's normal lag by an
    order of magnitude; during a sink outage (records legitimately up
    to ~5 min late on the retry budget) treat findings as "re-check
    after heal"."""
    ks = ks or Keyspace()
    now = time.time() if now is None else now
    out: List[Finding] = []

    jobs: Dict[Tuple[str, str], Job] = {}
    for kv in _scan(store, ks.cmd):
        rest = kv.key[len(ks.cmd):]
        if "/" not in rest:
            continue
        group, jid = rest.split("/", 1)
        try:
            job = Job.from_json(kv.value)
            job.group, job.id = group, jid
            jobs[(group, jid)] = job
        except Exception:  # noqa: BLE001 — malformed doc IS a finding
            out.append(Finding("malformed_job", kv.key,
                               "job document failed to parse"))
    job_ids = {jid for (_g, jid) in jobs}

    # 1. leaked reservations: dispatch keys far past their second
    for kv in _scan(store, ks.dispatch):
        ep = _dispatch_epoch(kv.key, ks)
        if ep is not None and ep < now - stale_order_s:
            out.append(Finding(
                "leaked_reservation", kv.key,
                f"order scheduled {now - ep:.0f}s ago still present "
                f"(> {stale_order_s:.0f}s)"))

    # 2. orphan proc entries: running-execution keys for dead jobs
    for kv in _scan(store, ks.proc):
        seg = kv.key[len(ks.proc):].split("/")
        if len(seg) >= 3 and (seg[1], seg[2]) not in jobs:
            out.append(Finding(
                "orphan_proc", kv.key,
                f"proc entry references unknown job {seg[1]}/{seg[2]}"))

    # 3. dangling dep completions: DAG edge signals for dead jobs
    for kv in _scan(store, ks.dep):
        rest = kv.key[len(ks.dep):]
        if "/" not in rest:
            continue
        group, jid = rest.split("/", 1)
        if (group, jid) not in jobs:
            out.append(Finding(
                "dangling_dep", kv.key,
                f"dep completion for unknown job {group}/{jid}"))

    # 4. orphan fences: lock keys for jobs that no longer exist, and —
    #    with a sink — consumed fences with no execution record.  Only
    #    fences whose scheduled second is fence_settle_s in the past
    #    count toward the record cross-check: a just-claimed fence
    #    whose record is still riding the flush ladder (0.5-10 s
    #    behind) is in-flight state, not a finding — the in-flight
    #    tolerance every other fsck check applies, on the window that
    #    fits inside the fence key's own leased lifetime.
    fences: Dict[str, int] = {}
    for kv in _scan(store, ks.lock):
        rest = kv.key[len(ks.lock):]
        if rest.startswith("sched/"):
            # partitioned scheduler leader leases (lock/sched/p<i>) —
            # election state, not fences
            continue
        if rest.startswith("alone/"):
            jid = rest[len("alone/"):]
            if jid and jid not in job_ids:
                out.append(Finding(
                    "stuck_alone_lock", kv.key,
                    f"Alone lock held for unknown job {jid}"))
            continue
        jid, _, epoch_s = rest.partition("/")
        if jid not in job_ids:
            out.append(Finding(
                "orphan_fence", kv.key,
                f"fence for unknown job {jid}"))
            continue
        try:
            settled = int(epoch_s) < now - fence_settle_s
        except ValueError:
            settled = True      # unparsable second: treat as old
        if settled:
            fences[jid] = fences.get(jid, 0) + 1
    if sink is not None:
        for (group, jid), job in sorted(jobs.items()):
            nf = fences.get(jid, 0)
            if not nf or not job.exclusive:
                continue
            try:
                _rows, total = sink.query_logs(job_ids=[jid], page=1,
                                               page_size=1)
            except Exception as e:  # noqa: BLE001 — audit must report,
                out.append(Finding(   # not crash, on a degraded sink
                    "sink_unreadable", jid,
                    f"record count unavailable: {e}"))
                continue
            if total >= 0 and total < nf:
                out.append(Finding(
                    "fence_without_record", jid,
                    f"{nf} consumed fences but only {total} execution "
                    f"records (crashed mid-execution, or record loss)"))
    return out


def replication_audit(store) -> List[Finding]:
    """Replica-group divergence audit (replication plane, repl/),
    read-only: for every shard served by an ``addr1|addr2|addr3``
    replica group, image each reachable replica's key/value state AT OR
    BELOW the group's minimum applied revision — the prefix of history
    every member claims to have applied — and compare it against the
    leader's.  Identical prefixes are the WAL-shipping contract; a
    mismatch is replicated-state corruption and is NAMED with the first
    divergent key.

    Candidate divergences are re-verified with fresh point reads
    before being reported, which absorbs the usual race (a key written
    or deleted between the two scans); on a heavily-written fleet
    re-run the audit to confirm a finding.  Unreplicated shards and
    plain clients are skipped silently."""
    from ..repl import ReplicaGroupStore
    out: List[Finding] = []
    raw = getattr(store, "_raw", None)
    clients = list(raw) if raw is not None else [store]
    for i, cli in enumerate(clients):
        if not isinstance(cli, ReplicaGroupStore):
            continue
        statuses = cli.replica_statuses()
        live = {a: st for a, st in statuses.items()
                if isinstance(st, dict) and st.get("enabled")}
        for addr, st in sorted(statuses.items()):
            if st is None:
                out.append(Finding(
                    "replica_unreachable", addr,
                    f"shard {i}: replica did not answer repl_status"))
        if len(live) < 2:
            continue
        leaders = [a for a, st in live.items()
                   if st.get("role") == "leader"]
        if not leaders:
            out.append(Finding(
                "replica_leaderless", f"shard{i}",
                f"shard {i}: no reachable replica claims leadership "
                f"of group {cli.addrs}"))
            continue
        leader = max(leaders, key=lambda a: int(live[a].get("epoch", 0)))
        min_rev = min(int(st.get("applied_rev", 0))
                      for st in live.values())

        def image(addr):
            c = cli.dial_replica(addr)
            try:
                return {kv.key: kv.value
                        for kv in c.get_prefix_paged("")
                        if kv.mod_rev <= min_rev}
            finally:
                c.close()

        def point_read(addr, key):
            c = cli.dial_replica(addr)
            try:
                kv = c.get(key)
                return None if kv is None else kv.value
            finally:
                c.close()

        base = image(leader)
        for addr in sorted(live):
            if addr == leader:
                continue
            img = image(addr)
            for k in sorted(set(base) | set(img)):
                if base.get(k) == img.get(k):
                    continue
                # re-verify: the scans race live writes
                lv, fv = point_read(leader, k), point_read(addr, k)
                if lv == fv:
                    continue
                out.append(Finding(
                    "replica_divergence", k,
                    f"shard {i}: replica {addr} diverges from leader "
                    f"{leader} below min applied rev {min_rev} "
                    f"(leader={lv!r}, replica={fv!r})"))
                break       # the FIRST divergent key names the finding
    return out


def render(findings: List[Finding]) -> str:
    if not findings:
        return "fsck: clean (0 findings)"
    by_code: Dict[str, int] = {}
    for f in findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    lines = [f"fsck: {len(findings)} finding(s): " + ", ".join(
        f"{c}={n}" for c, n in sorted(by_code.items()))]
    lines += [f"  {f}" for f in findings]
    return "\n".join(lines)


def to_json(findings: List[Finding]) -> str:
    return json.dumps([dataclasses.asdict(f) for f in findings],
                      indent=2)
