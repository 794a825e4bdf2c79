"""Read-plane benchmark: queries/s and latency percentiles for the
dashboard shapes WHILE the write path runs at full drain — now with
tiering and response-cache effectiveness.

Shapes (readers are DEDICATED round-robin — reader k drives shape
k mod 3 — so each shape's qps is its own ceiling over the shared
window, not the cycle rate of the slowest shape; use >= 3 readers to
cover all shapes):

- ``latest``    — the dashboard's landing view
  (``query_logs(latest=True, page_size=500)``)
- ``history``   — a paged, filtered job-history read; with
  ``--cold-fraction F`` that fraction of history reads target the
  aged-out day, forcing the hot+cold segment merge (latency reported
  SPLIT: ``history_hot`` vs ``history_cold``)
- ``stat_days`` — the overview counters (``stat_days(7)``)
- ``web``       — an in-process ApiServer poll of /v1/logs?latest and
  /v1/stat/days carrying If-None-Match, measuring the 304 rate and the
  response cache's per-shard partial reuse (an idle-phase poll after
  the writer stops gives the idle 304 rate a real dashboard sees)

Tiering effectiveness comes from the sink's own op counters
(``q_*_hot`` vs ``query_sql`` — logsink/joblog.py): per-shape hot-tier
hit ratios land beside the qps numbers.  ``--tiering off`` runs the
identical load with ``CRONSUN_TIERING=off`` in the shard servers — the
rollback baseline the slow gate compares against.

    python -m cronsun_tpu_torch.scripts.bench_query [--logd-shards N]
        [--readers M]
        [--seconds S] [--cold-fraction F] [--tiering on|off]
        [--json out.json]

Backend: native logd when the binary exists, BENCH_LOGD=py forces the
Python/SQLite server (each shard its own ``bin.logd`` process).  Run
standalone or via bench.py (which merges ``query_plane_*`` into
bench_detail.json).

Copy of ``scripts/bench_query.py`` on the port's modules: the same flags,
JSON keys and output; every child process it spawns runs
``python -m cronsun_tpu_torch.scripts.bench_query`` or a
``cronsun_tpu_torch.bin`` launcher (or ``native/``'s servers).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SELF = (sys.executable, "-m", "cronsun_tpu_torch.scripts.bench_query")

SHAPES = ("latest", "history", "stat_days")


def _pctl(xs, q):
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def run_query_bench(logd_shards=1, readers=4, seconds=4.0, on_log=print,
                    seed_records=4000, cold_fraction=0.0, tiering=True,
                    web_poll=True, write_rate=0):
    from ..logsink import LogRecord
    from ..logsink.native import find_binary as find_logd
    from ..logsink.sharded import connect_sharded_sink
    from .bench_dispatch import _PyLogShardServer
    from ..logsink.native import NativeLogSinkServer

    logd_shards = max(1, logd_shards)
    cold_fraction = max(0.0, min(1.0, cold_fraction))
    logd_bin = (None if os.environ.get("BENCH_LOGD") == "py"
                else find_logd())
    backend = ("native-logd" if logd_bin else "py-logd") + (
        f"x{logd_shards}-shards" if logd_shards > 1 else "")
    backend += "+tiered" if tiering else "+untiered"
    env = {"CRONSUN_TIERING": "on" if tiering else "off"}
    hot_days = 1 if cold_fraction > 0 else 0
    tmpdir = tempfile.mkdtemp(prefix="bench_query_") if hot_days else None
    logds = []
    sink = None
    jobs = [f"qj{i}" for i in range(64)]
    nodes = [f"qn{i}" for i in range(8)]
    now0 = time.time()
    cold_day_ts = now0 - 2 * 86400.0   # two days back: ages out cleanly

    def mkrec(i, cold=False):
        t = cold_day_ts + (i % 3600) if cold else time.time()
        return LogRecord(job_id=jobs[i % len(jobs)], job_group="q",
                         name=f"query-bench-{i % len(jobs)}",
                         node=nodes[i % len(nodes)], user="",
                         command="true", output="bench",
                         success=i % 7 != 0, begin_ts=t, end_ts=t)

    side_sinks = []
    try:
        prev_tier = os.environ.get("CRONSUN_TIERING")
        for si in range(logd_shards):
            if logd_bin:
                # the native child reads CRONSUN_TIERING from its
                # inherited environment; restored right after the spawns
                os.environ.update(env)
                try:
                    logds.append(NativeLogSinkServer(
                        binary=logd_bin,
                        db=(os.path.join(tmpdir, f"q{si}.wal")
                            if tmpdir else None),
                        hot_days=hot_days or None))
                finally:
                    if prev_tier is None:
                        os.environ.pop("CRONSUN_TIERING", None)
                    else:
                        os.environ["CRONSUN_TIERING"] = prev_tier
            else:
                extra = []
                if tmpdir:
                    extra += ["--db", os.path.join(tmpdir, f"q{si}.db"),
                              "--hot-days", str(hot_days)]
                logds.append(_PyLogShardServer(tuple(extra), env=env))
        addrs = [f"{l.host}:{l.port}" for l in logds]
        sink = connect_sharded_sink(addrs)

        def own_sink():
            # one client PER thread: the wire client is lock-step under
            # one mutex, so a shared client would measure client-side
            # lock waits (readers queued behind the writer's bulk RPC),
            # not the server's read/write concurrency
            s = connect_sharded_sink(addrs)
            side_sinks.append(s)
            return s
        on_log(f"seeding {seed_records} records ({backend}"
               + (f", cold_fraction={cold_fraction}" if cold_fraction
                  else "") + ")")
        n_cold_seed = int(seed_records * cold_fraction)
        n = 0
        while n < seed_records:
            batch = [mkrec(n + k, cold=(n + k) < n_cold_seed)
                     for k in range(500)]
            sink.create_job_logs(batch)
            n += len(batch)
        aged = 0
        if hot_days:
            try:
                aged = sink.age_out()
            except Exception:  # noqa: BLE001 — pre-tiering server
                aged = -1
            on_log(f"aged {aged} records into cold day segments")

        # ops snapshot BEFORE the measured window: hot-hit ratios come
        # from the delta, not the seeding traffic
        def ops_counts():
            try:
                return {k: v["count"] for k, v in sink.op_stats().items()}
            except Exception:  # noqa: BLE001 — older server
                return {}
        ops0 = ops_counts()

        # in-process web tier over the same sink: the response-cache /
        # 304 measurement (transport-independent dispatch — no HTTP
        # socket costs polluting the cache numbers)
        web = None
        if web_poll:
            from ..store.memstore import MemStore
            from ..web.server import ApiServer
            web = ApiServer(MemStore(), sink, auth_enabled=False,
                            cache_enabled=True)

        stop = threading.Event()
        wrote = [0]
        werrs = [0]

        # the writer runs as its OWN process: the harness's reader
        # threads decode hundreds of 512-record replies per second —
        # enough GIL load that an in-harness writer thread measures the
        # harness's GIL, not the plane, and a paced "equal ingest" run
        # silently under-delivers its target rate
        import subprocess
        wproc = subprocess.Popen(
            [*SELF, "--writer-mode",
             "--writer-addrs", ",".join(addrs),
             "--write-rate", str(write_rate)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=ROOT)

        def writer_counts():
            # "W <wrote> <errors>" lines, one per beat
            for line in wproc.stdout:
                parts = line.split()
                if len(parts) == 3 and parts[0] == "W":
                    wrote[0] = int(parts[1])
                    werrs[0] = int(parts[2])

        lat_keys = SHAPES + ("history_hot", "history_cold")
        lats = {s: [] for s in lat_keys}
        counts = {s: 0 for s in lat_keys}
        rerrs = [0]
        lock = threading.Lock()
        hot_begin = now0 - 3600.0            # prunes every cold segment
        cold_begin = cold_day_ts - (cold_day_ts % 86400.0)

        def reader(k):
            # one SHAPE per reader (round-robin): readers cycling all
            # three shapes made every shape's qps the CYCLE rate — the
            # slowest (SQL-bound history) gated the hot shapes' number
            # and the tiering win never showed in throughput.  A
            # dedicated reader measures each shape's own ceiling over
            # the same wall-clock window.
            import random
            shape = SHAPES[k % len(SHAPES)]
            rng = random.Random(k)
            rsink = own_sink()
            while not stop.is_set():
                split = shape
                t0 = time.perf_counter()
                try:
                    if shape == "latest":
                        rsink.query_logs(latest=True, page_size=500)
                    elif shape == "history":
                        cold = rng.random() < cold_fraction
                        split = ("history_cold" if cold
                                 else "history_hot")
                        kw = (dict(begin=cold_begin,
                                   end=cold_begin + 86400.0)
                              if cold else dict(begin=hot_begin))
                        rsink.query_logs(
                            job_ids=rng.sample(jobs, 3),
                            failed_only=rng.random() < 0.3,
                            page=2, page_size=50, **kw)
                    else:
                        rsink.stat_days(7)
                except Exception:  # noqa: BLE001 — counted
                    with lock:
                        rerrs[0] += 1
                    continue
                dt = (time.perf_counter() - t0) * 1000
                with lock:
                    lats[shape].append(dt)
                    counts[shape] += 1
                    if split != shape:
                        lats[split].append(dt)
                        counts[split] += 1

        web_counts = {"polls": 0, "not_modified": 0, "errors": 0,
                      "latest_200": 0, "stat_days_200": 0}
        web_idle = {"polls": 0, "not_modified": 0,
                    "latest_200": 0, "stat_days_200": 0}

        def web_reader(counters, stop_ev):
            from ..web.server import NotModified
            etags = {}
            shapes = [("/v1/logs", {"latest": "true", "pageSize": "500"},
                       "latest_200"),
                      ("/v1/stat/days", {"days": "7"}, "stat_days_200")]
            while not stop_ev.is_set():
                for path, q, ck in shapes:
                    hdr = ({"If-None-Match": etags[path]}
                           if path in etags else {})
                    try:
                        _r, ctx = web.handle("GET", path, q, b"", {}, hdr)
                        if "ETag" in ctx.out_headers:
                            etags[path] = ctx.out_headers["ETag"]
                        counters["polls"] += 1
                        # a 200 may have queried the sink (per changed
                        # shard) — counted into the hot-ratio
                        # denominator so web traffic can't inflate it
                        counters[ck] += 1
                    except NotModified:
                        counters["polls"] += 1
                        counters["not_modified"] += 1
                    except Exception:  # noqa: BLE001 — counted
                        counters["errors"] = counters.get("errors", 0) + 1

        wt = threading.Thread(target=writer_counts, daemon=True)
        rts = [threading.Thread(target=reader, args=(k,), daemon=True)
               for k in range(readers)]
        if web is not None:
            rts.append(threading.Thread(target=web_reader,
                                        args=(web_counts, stop),
                                        daemon=True))
        t0 = time.time()
        wt.start()
        for t in rts:
            t.start()
        time.sleep(seconds)
        stop.set()
        elapsed = time.time() - t0
        wproc.terminate()
        try:
            wproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            wproc.kill()
        wt.join(timeout=10)
        for t in rts:
            t.join(timeout=10)

        # ops snapshot BEFORE the idle phase: the hot-ratio delta must
        # cover exactly the measured window's traffic
        ops1 = ops_counts()

        # idle phase: the writer is quiet — the 304 rate a real
        # dashboard sees between executions (every poll but the first
        # per shape should 304)
        if web is not None:
            idle_stop = threading.Event()
            it = threading.Thread(target=web_reader,
                                  args=(web_idle, idle_stop), daemon=True)
            it.start()
            time.sleep(min(1.0, seconds / 4))
            idle_stop.set()
            it.join(timeout=10)

        dops = {k: ops1.get(k, 0) - ops0.get(k, 0)
                for k in set(ops0) | set(ops1)}

        res = {
            "query_plane_backend": backend,
            "query_plane_logd_shards": logd_shards,
            "query_plane_readers": readers,
            "query_plane_seconds": round(elapsed, 2),
            "query_plane_tiering": bool(tiering),
            "query_plane_write_rate_target": write_rate,
            "query_plane_cold_fraction": cold_fraction,
            "query_plane_aged_records": aged,
            "query_plane_write_records_per_s": round(wrote[0] / elapsed, 1),
            "query_plane_write_errors": werrs[0],
            "query_plane_read_errors": rerrs[0],
        }
        for s in lat_keys:
            res[f"query_plane_{s}_qps"] = round(counts[s] / elapsed, 1)
            res[f"query_plane_{s}_p50_ms"] = round(_pctl(lats[s], 0.50), 2)
            res[f"query_plane_{s}_p99_ms"] = round(_pctl(lats[s], 0.99), 2)
        # per-shape hot-tier hit ratio from the sink's own op counters
        # (each issued query touches every shard once, so the server
        # count normalizes by issued * nshards)
        nsh = max(1, logd_shards)
        # the latest view counts BOTH mirror recomputes and serialized-
        # reply memo hits as hot — a memo hit is the hot tier at its
        # cheapest (zero marshalling).  The denominator includes the
        # web poller's 200s (its recomputes bump the same server
        # counters; ignoring them inflated the ratio).  The web cache's
        # partial reuse means some 200s query FEWER than nsh shards, so
        # the ratio is conservative — it can under-report, never
        # inflate.
        latest_hot = dops.get("q_latest_hot", 0) + dops.get(
            "q_latest_memo", 0)
        for shape, hot, issued in (
                ("latest", latest_hot,
                 counts["latest"] + web_counts["latest_200"]),
                ("stat_days", dops.get("q_stat_hot", 0),
                 counts["stat_days"] + web_counts["stat_days_200"])):
            if issued:
                res[f"query_plane_{shape}_hot_ratio"] = round(
                    min(1.0, hot / (issued * nsh)), 3)
        if counts["history"]:
            res["query_plane_history_cold_merge_ratio"] = round(
                min(1.0, dops.get("q_history_cold", 0)
                    / (counts["history"] * nsh)), 3)
        res["query_plane_sql_queries"] = dops.get("query_sql", 0)
        if web is not None:
            res["query_plane_web_poll_qps"] = round(
                web_counts["polls"] / elapsed, 1)
            res["query_plane_web_304_rate"] = round(
                web_counts["not_modified"] / max(1, web_counts["polls"]),
                3)
            res["query_plane_web_304_rate_idle"] = round(
                web_idle["not_modified"] / max(1, web_idle["polls"]), 3)
            res["query_plane_web_errors"] = web_counts.get("errors", 0)
            if web.cache is not None:
                for k, v in web.cache.snapshot().items():
                    res[f"query_plane_web_cache_{k}"] = v
        try:
            res["query_plane_logd_op_stats"] = sink.op_stats()
        except Exception:  # noqa: BLE001 — older server
            pass
        on_log(" ".join(f"{s}={res[f'query_plane_{s}_qps']}/s"
                        f"(p99 {res[f'query_plane_{s}_p99_ms']}ms)"
                        for s in SHAPES)
               + f" writes={res['query_plane_write_records_per_s']}/s"
               + (f" 304={res.get('query_plane_web_304_rate_idle', 0)}"
                  "(idle)" if web is not None else ""))
        return res
    finally:
        for s in [sink] + side_sinks:
            if s is None:
                continue
            try:
                s.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for l in logds:
            try:
                l.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


def writer_main(addrs: str, write_rate: int) -> int:
    """The ingest harness as its own process (see run_query_bench):
    full-drain or paced bulk flushes until terminated, reporting
    "W <wrote> <errors>" after every batch."""
    from ..logsink import LogRecord
    from ..logsink.sharded import connect_sharded_sink
    jobs = [f"qj{i}" for i in range(64)]
    nodes = [f"qn{i}" for i in range(8)]

    def mkrec(i):
        t = time.time()
        return LogRecord(job_id=jobs[i % len(jobs)], job_group="q",
                         name=f"query-bench-{i % len(jobs)}",
                         node=nodes[i % len(nodes)], user="",
                         command="true", output="bench",
                         success=i % 7 != 0, begin_ts=t, end_ts=t)
    sink = connect_sharded_sink(addrs.split(","))
    wrote = errs = 0
    t_start = time.time()
    while True:
        if write_rate > 0:
            ahead = wrote - (time.time() - t_start) * write_rate
            if ahead > 0:
                time.sleep(min(0.05, ahead / write_rate))
                continue
        batch = [mkrec(1_000_000 + wrote + k) for k in range(500)]
        try:
            sink.create_job_logs(batch)
            wrote += len(batch)
        except Exception:  # noqa: BLE001 — counted, keep driving
            errs += 1
        print(f"W {wrote} {errs}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logd-shards", type=int, default=1)
    ap.add_argument("--readers", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--cold-fraction", type=float, default=0.0,
                    help="fraction of history reads that cross the "
                         "hot/cold tier boundary (ages a seeded old "
                         "day into segment files first)")
    ap.add_argument("--tiering", choices=("on", "off"), default="on",
                    help="'off' runs the identical load with "
                         "CRONSUN_TIERING=off — the rollback baseline")
    ap.add_argument("--write-rate", type=int, default=0,
                    help="pace ingest at N records/s (0 = full drain); "
                         "the equal-ingest mode the tiering gate "
                         "compares under")
    ap.add_argument("--no-web", action="store_true",
                    help="skip the in-process web-tier 304/cache poll")
    ap.add_argument("--json", default=None)
    # internal: the ingest subprocess (run_query_bench spawns it)
    ap.add_argument("--writer-mode", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--writer-addrs", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.writer_mode:
        return writer_main(args.writer_addrs, args.write_rate)
    on_log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    res = run_query_bench(logd_shards=args.logd_shards,
                          readers=args.readers, seconds=args.seconds,
                          cold_fraction=args.cold_fraction,
                          tiering=args.tiering == "on",
                          write_rate=args.write_rate,
                          web_poll=not args.no_web,
                          on_log=on_log)
    out = json.dumps(res, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
