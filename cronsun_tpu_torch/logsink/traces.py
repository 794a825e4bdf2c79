"""Trace store: the result plane's span sink (fire-lifecycle tracing).

Spans arrive piggybacked on the agents' record flushes
(``create_job_logs(..., spans=[...])`` — zero extra RPCs) and land in

- a bounded in-memory RING keyed by trace id (newest evicts oldest;
  the operator surface ``/v1/trace/...`` and ``cronsun-ctl trace``
  read it), merged last-write-wins per (trace, node) so a retried
  batch re-merges identical values instead of duplicating; and
- an append-only per-day SPILL file beside the tiered store's segment
  directory (``<db>.traces/<day>.jsonl``, one JSON line per span
  batch entry) for traces that have aged out of the ring — the same
  day-file layout the cold tier uses, readable offline.

Ingest also folds every span's stage durations into fixed-bucket
per-stage histograms (trace.BUCKETS_MS — identical fleet-wide, so the
counters aggregate across logd shards and replicas), served as the
``trace_stats`` op and rendered by the web tier as
``cronsun_trace_stage_ms_{bucket,sum,count}{stage=...}``.

Copy of ``cronsun_tpu/logsink/traces.py``.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .. import log, trace as _trace


class TraceStore:
    """Bounded trace ring + per-day spill + per-stage histograms.
    ``spill_dir`` None (in-memory sinks) keeps the ring only."""

    def __init__(self, cap: int = 4096, spill_dir: Optional[str] = None):
        self.cap = cap
        self.spill_dir = spill_dir
        self._mu = threading.Lock()
        # tid -> {"job", "grp", "sec", "spans": {node: span dict}}
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._stage_hist: Dict[str, list] = {
            s: [0] * (len(_trace.BUCKETS_MS) + 1) for s in _trace.STAGES}
        self._stage_sum: Dict[str, float] = {s: 0.0 for s in _trace.STAGES}
        self._stage_cnt: Dict[str, int] = {s: 0 for s in _trace.STAGES}
        self._spans_total = 0
        self._spill_day = None
        self._spill_f = None

    # ---- ingest ----------------------------------------------------------

    def ingest(self, spans: List[dict]) -> int:
        """Merge a span batch; returns the number accepted.  Malformed
        entries are skipped (the record path must never fail on a bad
        span sidecar)."""
        n = 0
        spill: List[str] = []
        with self._mu:
            for sp in spans:
                if not isinstance(sp, dict):
                    continue
                tid = sp.get("tid")
                job = sp.get("job")
                sec = sp.get("sec")
                ts = sp.get("ts")
                if not (isinstance(tid, str) and isinstance(job, str)
                        and isinstance(sec, int)
                        and isinstance(ts, dict)):
                    continue
                ent = self._ring.get(tid)
                if ent is None:
                    ent = {"tid": tid, "job": job,
                           "grp": sp.get("grp", ""), "sec": sec,
                           "spans": {}}
                    self._ring[tid] = ent
                    if len(self._ring) > self.cap:
                        self._ring.popitem(last=False)
                else:
                    self._ring.move_to_end(tid)
                node = sp.get("node", "")
                prev = ent["spans"].get(node)
                if prev is not None:
                    # LWW merge per (trace, node): a batch retry
                    # re-sends identical stamps; a later flush stamp
                    # (re-stamped per attempt) overwrites
                    prev["ts"].update(ts)
                    prev["ok"] = bool(sp.get("ok", prev.get("ok", True)))
                else:
                    ent["spans"][node] = {
                        "node": node, "ok": bool(sp.get("ok", True)),
                        "grp": sp.get("grp", ""), "ten": sp.get("ten"),
                        "ts": dict(ts)}
                for stage, ms in _trace.stage_durations(sec, ts).items():
                    bi = bisect.bisect_left(_trace.BUCKETS_MS, ms)
                    self._stage_hist[stage][bi] += 1
                    self._stage_sum[stage] += ms
                    self._stage_cnt[stage] += 1
                self._spans_total += 1
                n += 1
                if self.spill_dir is not None:
                    spill.append((int(sec),
                                  json.dumps(sp, separators=(",", ":"))))
            if spill:
                self._spill_locked(spill)
        return n

    def _spill_locked(self, entries: List[tuple]):
        """Append each span to the day file of ITS OWN scheduled
        second — get() opens exactly one day file, so a span filed
        under a neighboring day (a record flush straddling midnight)
        would be unrecoverable once the ring evicts it.  Batches are
        near-real-time, so one open file handles the overwhelmingly
        common case and the day rolls over at most once per batch.
        Best-effort: a disk error logs once and disables spill."""
        try:
            for sec, line in entries:
                day = time.strftime("%Y-%m-%d", time.gmtime(sec))
                if self._spill_day != day or self._spill_f is None:
                    if self._spill_f is not None:
                        self._spill_f.close()
                    os.makedirs(self.spill_dir, exist_ok=True)
                    self._spill_f = open(
                        os.path.join(self.spill_dir, f"{day}.jsonl"),
                        "a")
                    self._spill_day = day
                self._spill_f.write(line + "\n")
            self._spill_f.flush()
        except OSError as e:
            log.warnf("trace spill disabled: %s", e)
            self.spill_dir = None
            self._spill_f = None

    # ---- reads -----------------------------------------------------------

    def get(self, job_id: str, epoch_s: int) -> List[dict]:
        """Raw span dicts of one trace (one per executing node), ring
        first, then the scheduled day's spill file."""
        tid = str(_trace.trace_id(job_id, int(epoch_s)))
        with self._mu:
            ent = self._ring.get(tid)
            if ent is not None:
                return [dict(s, tid=ent["tid"], job=ent["job"],
                             sec=ent["sec"], ts=dict(s["ts"]))
                        for s in ent["spans"].values()]
        if self.spill_dir is None:
            return []
        day = time.strftime("%Y-%m-%d", time.gmtime(int(epoch_s)))
        path = os.path.join(self.spill_dir, f"{day}.jsonl")
        out: Dict[str, dict] = {}
        try:
            with open(path) as f:
                for ln in f:
                    try:
                        sp = json.loads(ln)
                    except json.JSONDecodeError:
                        continue
                    if sp.get("tid") != tid:
                        continue
                    node = sp.get("node", "")
                    prev = out.get(node)
                    if prev is not None:
                        prev["ts"].update(sp.get("ts") or {})
                    else:
                        out[node] = sp
        except OSError:
            return []
        return list(out.values())

    def top(self, n: int = 256) -> List[dict]:
        """Most-recent ring traces summarized (tid, job, sec, per-node
        stage durations, total) — the web sorts by total or any stage;
        the backend stays dumb so py and native agree by construction."""
        with self._mu:
            ents = list(self._ring.values())[-max(1, n):]
        out = []
        for ent in ents:
            nodes = []
            for s in ent["spans"].values():
                nodes.append({
                    "node": s["node"], "ok": s.get("ok", True),
                    "stages": _trace.stage_durations(ent["sec"], s["ts"]),
                    "total_ms": _trace.span_total_ms(ent["sec"], s["ts"]),
                })
            if not nodes:
                continue
            out.append({"tid": ent["tid"], "job": ent["job"],
                        "grp": ent.get("grp", ""), "sec": ent["sec"],
                        "total_ms": max(x["total_ms"] for x in nodes),
                        "nodes": nodes})
        return out

    def stats(self) -> dict:
        """Cumulative per-stage histogram counters (the trace_stats
        wire op): {stage: {buckets, sum, count}} + spans_total."""
        with self._mu:
            return {
                "spans_total": self._spans_total,
                "stages": {
                    s: {"buckets": list(self._stage_hist[s]),
                        "sum": round(self._stage_sum[s], 3),
                        "count": self._stage_cnt[s]}
                    for s in _trace.STAGES if self._stage_cnt[s]}}

    def close(self):
        with self._mu:
            if self._spill_f is not None:
                try:
                    self._spill_f.close()
                except OSError:
                    pass
                self._spill_f = None
