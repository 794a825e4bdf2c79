"""Fire-lifecycle tracing — deterministic trace ids, head sampling and
waterfall assembly for the trace plane.

Every fire owns a deterministic 64-bit trace id
``fnv1a64("<job_id>|<scheduled_second>")`` — no coordination, computed
independently by the scheduler, both agents (agent.py and agentd.cc)
and the web tier, the same hash-parity pattern the sharded store routes
by.  A head-sampled subset (low trace-id bits, ``trace_sample_shift``;
plus per-job ``trace: true`` and every failed execution) carries span
timestamps through the lifecycle:

- the scheduler stamps the order-build wall time into the coalesced
  (node, second) order value as a trailing ``{"tb": <ts>}`` element
  (legacy agents already skip non-string entries, and spanless legacy
  values still parse on new agents — both directions are wire-safe);
- agents stamp receive/claim/exec-start/exec-end and ship the span
  piggybacked on the existing record flush (zero new RPCs), stamping
  the flush time as the batch leaves;
- logd keeps spans in a bounded in-memory ring plus a per-day spill
  file beside the tiered store (logsink/traces.py);
- the web tier assembles the waterfall at ``GET /v1/trace/<job>/<sec>``
  (``assemble`` below is the one stage-math implementation).

Timestamps are wall-clock seconds; per-stage durations are clamped at
zero (planning runs AHEAD of the scheduled second, and cross-process
clock skew must never render a negative bar).  Trace ids travel as
DECIMAL STRINGS on every wire — they exceed 2^53, so a JSON double
(the C++ parser, browsers) would silently corrupt them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def fnv1a64(s: str) -> int:
    """64-bit FNV-1a over UTF-8 bytes — must stay bit-identical to
    store.sharded.fnv1a and the C++ twins (pinned by test)."""
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def fnv_partial(s: str) -> int:
    """Hash state after ``s`` — the scheduler precomputes the per-row
    prefix ``"<job_id>|"`` once and continues with the (shared)
    epoch-second suffix per planned second."""
    return fnv1a64(s)


def fnv_continue(state: int, s: str) -> int:
    h = state
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def fnv_continue_vec(states, s: str):
    """Vectorized continue: ``states`` is a np.uint64 array of per-row
    partial hashes; returns the per-row trace ids after hashing the
    (ASCII) suffix ``s``.  np.uint64 arithmetic wraps mod 2^64, which
    is exactly FNV's modulus — ~len(s) vectorized ops per planned
    second instead of a per-fire Python hash loop."""
    import numpy as np
    h = states.astype(np.uint64, copy=True)
    prime = np.uint64(_FNV_PRIME)
    for b in s.encode():
        h = (h ^ np.uint64(b)) * prime
    return h


def trace_id(job_id: str, epoch_s: int) -> int:
    return fnv1a64(f"{job_id}|{int(epoch_s)}")


DEFAULT_SHIFT = 8          # head-sample 1/256 of fires by default


def armed() -> bool:
    """Global kill switch: CRONSUN_TRACE=off disables every stamping
    site (order wire byte-identical, zero span work)."""
    return os.environ.get("CRONSUN_TRACE", "").lower() not in (
        "off", "0", "false")


def head_sampled(tid: int, shift: int) -> bool:
    """Head sampling by trace-id bits: shift=0 samples everything,
    shift=8 one fire in 256; negative = never.  Deterministic — every
    component reaches the same verdict for one (job, second) with no
    coordination."""
    if shift < 0:
        return False
    return (tid & ((1 << shift) - 1)) == 0


# The six lifecycle stages, in waterfall order.  Each is the clamped
# difference of two stamped timestamps (see assemble); a stage whose
# stamps are missing (legacy spanless order, Common fire without a
# claim) is simply absent from the waterfall.
STAGES = ("sched", "publish", "claim", "queue", "run", "record")

# Fixed histogram bucket upper bounds (ms) — identical in every
# component so the counters aggregate across replicas and shards.
BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
              1000.0, 2000.0, 5000.0, 10000.0)


def stage_durations(sec: int, ts: Dict[str, float]) -> Dict[str, float]:
    """Per-stage durations (ms) from one span's stamped timestamps:

    - sched:   scheduled second -> order built (``tb``); 0 when the
               window was planned ahead of time (the normal case),
               positive under catch-up lateness
    - publish: order built -> agent receipt (publisher queue + store
               put + watch fan-out)
    - claim:   due (or receipt, whichever is later) -> fence settled
    - queue:   fence settled -> exec start (agent pool queueing)
    - run:     exec start -> exec end
    - record:  exec end -> record batch flushed to logd
    """
    out: Dict[str, float] = {}

    def stage(name, a, b):
        if a is None or b is None:
            return
        out[name] = round(max(0.0, (b - a)) * 1e3, 3)

    b, recv = ts.get("b"), ts.get("recv")
    claim, start = ts.get("claim"), ts.get("start")
    end, flush = ts.get("end"), ts.get("flush")
    stage("sched", float(sec), b)
    stage("publish", b, recv)
    if claim is not None:
        base = max(float(sec), recv) if recv is not None else float(sec)
        stage("claim", base, claim)
    stage("queue", claim if claim is not None else recv, start)
    stage("run", start, end)
    stage("record", end, flush)
    return out


def span_total_ms(sec: int, ts: Dict[str, float]) -> float:
    """Fire latency: scheduled second -> the span's last stamp."""
    last = max((v for v in ts.values() if isinstance(v, (int, float))),
               default=float(sec))
    return round(max(0.0, (last - float(sec))) * 1e3, 3)


def assemble(job_id: str, epoch_s: int,
             spans: List[dict]) -> Optional[dict]:
    """Build the waterfall reply from the stored span dicts of one
    trace (one per executing node; a Common fan-out yields several).
    Returns None when nothing was recorded."""
    if not spans:
        return None
    nodes = []
    for sp in spans:
        ts = sp.get("ts") or {}
        nodes.append({
            "node": sp.get("node", ""),
            "ok": bool(sp.get("ok", True)),
            "ts": ts,
            "stages": stage_durations(epoch_s, ts),
            "total_ms": span_total_ms(epoch_s, ts),
        })
    nodes.sort(key=lambda n: n["node"])
    grp = next((sp.get("grp") for sp in spans if sp.get("grp")), "")
    return {"trace_id": str(trace_id(job_id, epoch_s)),
            "job": job_id, "group": grp, "second": int(epoch_s),
            "nodes": nodes,
            "total_ms": max(n["total_ms"] for n in nodes)}
