"""End-to-end dispatch-plane benchmark.

Measures the path the reference actually spends its time on (SURVEY §3.2:
up to 3 etcd round trips + 4 Mongo writes per execution, job.go:404-470):

    scheduler orders --put_many--> native store --watch--> REAL NodeAgent
    processes --> (job,second) fence --> proc registry --> order consume
    --> execution record into the networked result store (cronsun-logd)

Everything is real except the fork/exec itself (a stub executor returns
instantly — at 50k orders/s the measurement would otherwise be of
/bin/echo).  Orders are offered at swept rates; for each rate the bench
records the sustained consume rate and whether the plane kept up, then
reports the saturation point.

    python -m cronsun_tpu_torch.scripts.bench_dispatch [--rates 1000,10000,50000]
        [--agents 4] [--seconds 4] [--json out.json]

Run standalone or via bench.py (which merges the result into
bench_detail.json as dispatch_plane_*).

Copy of ``scripts/bench_dispatch.py`` on the port's modules: the same flags,
JSON keys and output; every child process it spawns runs
``python -m cronsun_tpu_torch.scripts.bench_dispatch`` or a
``cronsun_tpu_torch.bin`` launcher (or ``native/``'s servers).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SELF = (sys.executable, "-m", "cronsun_tpu_torch.scripts.bench_dispatch")


# ---------------------------------------------------------------- worker

def worker_main(store_addr: str, logd_addr: str, node_id: str) -> int:
    """A real NodeAgent process with an instant executor.
    ``store_addr`` and ``logd_addr`` may be comma-separated shard sets
    — the agent then runs against the routing clients
    (store/sharded.py, logsink/sharded.py)."""
    from ..logsink.sharded import connect_sharded_sink
    from ..node.agent import NodeAgent
    from ..node.executor import ExecResult
    from ..store.sharded import connect_sharded

    class InstantExecutor:
        def run_job(self, job_id, command, user, timeout, retry,
                    interval, parallels, env=None, **kw):
            now = time.time()
            return ExecResult(success=True, output="bench", error="",
                              begin_ts=now, end_ts=now, skipped=False)

    store = connect_sharded(store_addr.split(","))
    sink = connect_sharded_sink(logd_addr.split(","))
    # proc_req=5: the reference sample default — sub-5s runs never touch
    # the proc registry (proc.go:218-236), exactly the short-job regime
    # this bench sweeps
    agent = NodeAgent(store, sink, node_id=node_id,
                      executor=InstantExecutor(), proc_req=5.0)
    # publish metrics snapshots fast enough for short sweeps to read
    # per-agent consumed counts (the fairness signal) and exec lag
    agent.metrics.interval_s = 2.0
    agent.start()
    print("READY", flush=True)
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    return 0


# ---------------------------------------------------------------- harness

class _PyProcServer:
    """A Python store/logd shard as its OWN PROCESS.

    An in-process ``.start()`` server thread would serve from inside
    the harness — N "shards" sharing one GIL measure nothing.  The whole
    point of the py rungs on a shard ladder is that each shard is a
    separate single-process ceiling (one GIL, one event plane / one
    SQLite lock), so each one must be a separate process, exactly like
    production."""

    def __init__(self, module="cronsun_tpu_torch.bin.store", extra=(), env=None):
        child_env = None
        if env:
            child_env = dict(os.environ)
            child_env.update(env)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module,
             "--host", "127.0.0.1", "--port", "0", *extra],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=child_env,
            cwd=ROOT)
        for _ in range(200):
            line = self.proc.stdout.readline()
            if not line or line.startswith("READY"):
                break
        if not line or not line.startswith("READY"):
            self.proc.kill()
            raise RuntimeError(f"py shard ({module}) failed to start: "
                               f"{line!r}")
        addr = line.split()[1]
        self.host, _, port = addr.rpartition(":")
        self.port = int(port)

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()


def _PyShardServer():
    return _PyProcServer("cronsun_tpu_torch.bin.store")


def _PyLogShardServer(extra=(), env=None):
    # :memory: — a bench logd must not leave cronsun.db files around
    # (bench_query overrides with a tempdir DB when it exercises the
    # cold tier, and with CRONSUN_TIERING=off for the untiered rung)
    if not any(a == "--db" for a in extra):
        extra = ("--db", ":memory:", *extra)
    return _PyProcServer("cronsun_tpu_torch.bin.logd", extra, env=env)


def _native_agent_workers(n_agents: int) -> str:
    """Worker threads per native bench agent.  The agentd default (64)
    assumes a dedicated machine; a bench fleet of 8 on one host would
    run 512 workers on ~24 cores and measure scheduler thrash, not the
    plane (measured: 64 workers drained 48k orders/s where 8 drained
    109k on a 24-core host).  Scale the pool to the fleet's share."""
    if os.environ.get("BENCH_WORKERS"):
        return os.environ["BENCH_WORKERS"]
    cores = os.cpu_count() or 8
    return str(max(4, min(64, (2 * cores) // max(1, n_agents))))


def run_bench(rates, n_agents, seconds, on_log=print, shards=1,
              logd_shards=1):
    from ..core import Keyspace
    from ..core.models import Job, JobRule
    from ..logsink.native import (NativeLogSinkServer,
                                            find_binary as find_logd)
    from ..logsink.sharded import connect_sharded_sink
    from ..store.native import NativeStoreServer, find_binary
    from ..store.sharded import connect_sharded

    ks = Keyspace()
    shards = max(1, shards)
    logd_shards = max(1, logd_shards)
    # every resource below tears down in the except: a failure starting
    # a later shard / logd / agent must not orphan the subprocesses
    # already spawned (Popen children outlive a dead harness)
    store_srvs = []
    logds = []
    store = sink = None
    agents = []
    try:
        # BENCH_STORE=py forces the Python store server even when the
        # native binary exists — the GIL-bound one-process backend is the
        # backend whose ceiling sharding REMOVES: the native server is
        # already striped and multithreaded inside one process, so
        # on a single host its shard curve measures leftover host headroom,
        # not the partitioning win.  Each py shard runs as its own
        # bin.store process (own GIL, own event plane) — in-process
        # StoreServer threads would shard nothing.
        binary = (None if os.environ.get("BENCH_STORE") == "py"
                  else find_binary())
        store_srvs = []
        for _ in range(shards):
            if binary:
                store_srvs.append(NativeStoreServer(binary=binary))
                backend = "native"
            else:
                store_srvs.append(_PyShardServer())
                backend = "py"
        if shards > 1:
            backend += f"x{shards}-shards"
        store_addr = ",".join(f"{s.host}:{s.port}" for s in store_srvs)
        # result plane: BENCH_LOGD=py forces the Python/SQLite logd —
        # the same ladder logic as BENCH_STORE (each py shard its own
        # bin.logd process; the one-process SQLite lock is the ceiling
        # result-plane sharding removes on one host)
        logd_bin = (None if os.environ.get("BENCH_LOGD") == "py"
                    else find_logd())
        for _ in range(logd_shards):
            logds.append(NativeLogSinkServer(binary=logd_bin) if logd_bin
                         else _PyLogShardServer())
        backend += "+native-logd" if logd_bin else "+py-logd"
        if logd_shards > 1:
            backend += f"x{logd_shards}-shards"
        logd_addr = ",".join(f"{l.host}:{l.port}" for l in logds)
        store = connect_sharded(store_addr.split(","))
        sink = connect_sharded_sink(logd_addr.split(","))

        import threading
        agents = []
        node_ids = [f"bench-agent-{i}" for i in range(n_agents)]
        agentd = os.path.join(ROOT, "native", "cronsun-agentd")
        use_native_agents = (os.environ.get("BENCH_AGENT", "py") == "native"
                             and os.path.exists(agentd))
        for nid in node_ids:
            if use_native_agents:
                # --instant-exec: the C++ agent skips the fork/exec and
                # returns success instantly — symmetric with the Python
                # workers' InstantExecutor, so the two curves compare the
                # PLANE cost per agent, not fork throughput
                # --workers: fleet-share sized (BENCH_WORKERS overrides) —
                # see _native_agent_workers.  --ttl 3: metrics snapshots
                # publish every ~1s (the keepalive beat), so the per-agent
                # consumed counts the fairness signal reads are fresh at
                # the end of a short sweep, not one stale beat behind.
                p = subprocess.Popen(
                    [agentd, "--store", store_addr,
                     "--logsink", logd_addr,
                     "--node-id", nid, "--proc-req", "5", "--instant-exec",
                     "--workers", _native_agent_workers(n_agents),
                     "--ttl", "3"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            else:
                p = subprocess.Popen(
                    [*SELF, "--worker", store_addr, logd_addr, nid],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    cwd=ROOT)
            agents.append(p)
        for p in agents:
            # log warnings may precede READY; read until it appears
            for _ in range(200):
                line = p.stdout.readline()
                if not line or "READY" in line:
                    break
            assert line and "READY" in line, f"agent failed: {line!r}"
            # keep draining forever (discarding): an undrained 64KB pipe
            # would block the agent mid-warning and wedge the plane being
            # measured
            def _drain(f=p.stdout):
                for _ in f:
                    pass
            threading.Thread(target=_drain, daemon=True).start()

        results = {"dispatch_plane_backend": backend
                   + ("+native-agents" if use_native_agents else ""),
                   "dispatch_plane_agents": n_agents,
                   "dispatch_plane_store_shards": shards,
                   "dispatch_plane_logd_shards": logd_shards,
                   # the whole plane (store server, logd, harness, agents)
                   # shares this host's cores; on 1 core the figure measures
                   # per-order CPU cost, not fleet scale-out (real agents
                   # are distributed across machines)
                   "dispatch_plane_cpu_cores": os.cpu_count()}
    except BaseException:
        for p in agents:
            try:
                p.kill()
            except Exception:
                pass
        for c in (store, sink):
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass
        for l in logds:
            try:
                l.stop()
            except Exception:
                pass
        for srv in store_srvs:
            try:
                srv.stop()
            except Exception:
                pass
        raise
    try:
        # one exclusive job per order slot at the highest rate; the agent
        # path then pays the real per-order costs: job fetch, fence
        # grant+put_if_absent, proc put/delete, order consume, avg_time
        # CAS, and the 4-write log record over the logd wire
        max_rate = max(rates)
        on_log(f"seeding {max_rate} jobs ({backend} store)")
        items = []
        for i in range(max_rate):
            j = Job(id=f"bj{i}", name=f"bench-{i}", group="bench",
                    command="true", kind=2,
                    rules=[JobRule(id="r", timer="* * * * * *",
                                   nids=[node_ids[i % n_agents]])])
            items.append((ks.job_key("bench", j.id), j.to_json()))
            if len(items) >= 10_000:
                store.put_many(items); items = []
        if items:
            store.put_many(items)

        delivered_before = 0
        per_rate = []
        lag_offset = 0.0
        legacy_orders = os.environ.get("BENCH_ORDER_FORMAT") == "legacy"
        for rate in rates:
            on_log(f"rate {rate}/s x {seconds}s ...")
            lease = store.grant(300.0)
            t_start = time.time()
            epoch0 = int(t_start) - 2      # past epochs run immediately
            # second e's orders (epoch0 + e) are published at wall time
            # t_start + e, so every exec-start lag carries this offset
            # by construction; the agents' lag ring holds the LAST
            # swept rate, so keep the last rate's offset for the net
            # figures below
            lag_offset = t_start - epoch0
            for e in range(seconds):
                orders = []
                if legacy_orders:
                    # pre-coalescing wire format (BENCH_ORDER_FORMAT=
                    # legacy): one key per fire — kept for comparison
                    for i in range(rate):
                        nid = node_ids[i % n_agents]
                        orders.append((
                            ks.dispatch_key(nid, epoch0 + e, "bench",
                                            f"bj{i}"),
                            '{"rule":"r","kind":2}'))
                else:
                    # the production wire format: ONE coalesced key per
                    # (node, second) whose value is the node's job list
                    # — what the scheduler publishes since the
                    # per-(node, second) coalescing change
                    per_node = {}
                    for i in range(rate):
                        per_node.setdefault(
                            node_ids[i % n_agents], []).append(
                                f"bench/bj{i}")
                    for nid, jobs in per_node.items():
                        orders.append((
                            ks.dispatch_bundle_key(nid, epoch0 + e),
                            json.dumps(jobs)))
                # pace the offer: one window write per second, like the
                # scheduler's one-bulk-write-per-window cadence
                for c in range(0, len(orders), 20_000):
                    store.put_many(orders[c:c + 20_000], lease=lease)
                sleep_left = (t_start + e + 1) - time.time()
                if sleep_left > 0:
                    time.sleep(sleep_left)
            offered = rate * seconds
            deadline = time.time() + max(30, seconds * 6)
            done = delivered_before
            # two drain boundaries, watched on SEPARATE timers:
            # - ORDER drain: the dispatch keyspace emptying means every
            #   offered order was claimed + acked — the COORDINATION-
            #   store boundary, what store scaling (stripes, shards)
            #   acts on; records still flow asynchronously behind it;
            # - RECORD drain: executions landed in the result store —
            #   the plane's end-to-end figure (the kept_up claim), also
            #   gated by logd ingest.
            # The order probe runs on its own fine-grained thread:
            # stat_overall() against a saturated logd blocks for whole
            # seconds, and sampling the dispatch count in that loop
            # quantized order_drained_at by the logd RPC time — a
            # multi-second, run-to-run-jittering bias on a ~6-10 s
            # drain window that swamped the shard-scaling ratio.
            # probe cadence adapts to the backlog: the py backend's
            # count_prefix is an O(total keys) GIL-bound scan, so a
            # fixed 50 ms poll against a deep backlog taxes the very
            # shards being measured; far from empty it backs off (the
            # drain timestamp only needs precision near zero)
            order_drained_at = [None]

            def _order_probe():
                while time.time() < deadline:
                    left = store.count_prefix(ks.dispatch)
                    if left == 0:
                        order_drained_at[0] = time.time()
                        return
                    # > 2 windows of bundle keys pending: empty is well
                    # over a second away, poll coarse; near-empty needs
                    # the fine cadence for the timestamp
                    time.sleep(0.05 if left <= 2 * n_agents else 0.25)
            probe = threading.Thread(target=_order_probe, daemon=True)
            probe.start()
            while time.time() < deadline:
                done = sink.stat_overall()["total"]
                if done - delivered_before >= offered:
                    break
                time.sleep(0.2)
            probe.join(timeout=5.0)
            if order_drained_at[0] is None \
                    and store.count_prefix(ks.dispatch) == 0:
                order_drained_at[0] = time.time()
            order_drained_at = order_drained_at[0]
            elapsed = time.time() - t_start
            got = done - delivered_before
            delivered_before = done
            consume_rate = got / elapsed
            order_rate = (offered / (order_drained_at - t_start)
                          if order_drained_at else 0.0)
            # kept_up is a RATE claim, not a drain claim (VERDICT r4
            # #6): a plane that eventually drains everything late is
            # not keeping up.  Sustained consume-rate must match the
            # offered rate within 5%.
            per_rate.append({"offered_per_s": rate, "consumed": got,
                             "offered": offered,
                             "consume_rate_per_s": round(consume_rate, 1),
                             "order_drain_per_s": round(order_rate, 1),
                             "kept_up": consume_rate >= rate * 0.95})
            on_log(f"  consumed {got}/{offered} in {elapsed:.1f}s "
                   f"-> {consume_rate:.0f}/s (orders {order_rate:.0f}/s)")
            # drain any stragglers before the next rate
            time.sleep(1.0)
            delivered_before = sink.stat_overall()["total"]

        sustained = max(r["consume_rate_per_s"] for r in per_rate)
        # saturation = the highest offered rate the plane still matched
        # (NOT the highest it eventually drained)
        kept = [r["offered_per_s"] for r in per_rate if r["kept_up"]]
        saturation = max(kept) if kept else 0
        # the PER-AGENT drain ceiling: the sweep's top rates sit past
        # saturation on purpose (the r5 question "where is the
        # bundle-mode ceiling" needs offered >> drained), so the peak
        # drain rate over agent count is the measured per-agent
        # ceiling in the swept order format
        drain_per_agent = round(sustained / max(1, n_agents), 1)
        # end-to-end SLA: scheduled second -> exec start, as published
        # by the (real) agents' metrics snapshots.  The ring holds the
        # most recent executions, i.e. the highest swept rate — at and
        # PAST saturation, so this is the draining-backlog worst case
        # (seconds of queueing), not the healthy-load figure; the
        # healthy-load bound lives in the scale soak's assertion
        # (tests/test_soak.py: p99 within window_s + publish slack).
        # Per-agent orders_consumed doubles as the FAIRNESS signal: a
        # plane that scales only because one agent hogs the drain shows
        # a min/max ratio far below 1.
        lag_p50, lag_p99, consumed_per_agent = [], [], []
        rec_flushes = rec_flush_records = rec_dropped = 0
        total_offered = sum(r["offered"] for r in per_rate)
        prev_counts = None
        for attempt in range(8):
            lag_p50, lag_p99, consumed_per_agent = [], [], []
            rec_flushes = rec_flush_records = rec_dropped = 0
            for kv in store.get_prefix(ks.metrics + "node/"):
                m = json.loads(kv.value)
                if "exec_start_lag_p99_s" in m:
                    lag_p50.append(m["exec_start_lag_p50_s"])
                    lag_p99.append(m["exec_start_lag_p99_s"])
                if "orders_consumed_total" in m:
                    consumed_per_agent.append(m["orders_consumed_total"])
                # record-plane health: flush batching + outage drops, as
                # published by both agents' record flushers
                rec_flushes += m.get("rec_flush_total", 0)
                rec_flush_records += m.get("rec_flush_records_total", 0)
                rec_dropped += m.get("rec_dropped_total", 0)
            # agents publish snapshots on a ~1-2 s beat; right after a
            # drain some are a beat behind, which reads as a bogus
            # fairness collapse — a 0 count from a live agent, or
            # (sharded: pinned watches decouple the shards, so agents
            # finish seconds apart) a late finisher's mid-drain count.
            # Agents count consumption at CLAIM time and the keyspace
            # probe proved every offered order claimed, so the
            # snapshots are final exactly when they SUM to the offered
            # total; stable-but-short counts (stability alone can be
            # two reads of the same stale snapshot while an agent's
            # publish beat is stuck behind a saturated store) keep
            # waiting until the attempt budget runs out.
            counts = sorted(consumed_per_agent)
            done = sum(consumed_per_agent) >= total_offered
            if (len(consumed_per_agent) >= n_agents
                    and min(consumed_per_agent) > 0
                    and (done or (counts == prev_counts
                                  and attempt >= 5))):
                break
            prev_counts = counts
            time.sleep(1.6)
        order_drain = max(r["order_drain_per_s"] for r in per_rate)
        results.update({
            "dispatch_plane_sweep": per_rate,
            "dispatch_plane_orders_per_sec": round(sustained, 1),
            "dispatch_plane_order_drain_per_sec": round(order_drain, 1),
            "dispatch_plane_saturation_offered_per_sec": saturation,
            "dispatch_plane_drain_per_agent_per_sec": drain_per_agent,
            "dispatch_plane_order_format":
                "legacy" if legacy_orders else "coalesced",
        })
        if consumed_per_agent and max(consumed_per_agent) > 0:
            results["dispatch_plane_fairness_min_over_max"] = round(
                min(consumed_per_agent) / max(consumed_per_agent), 3)
        # per-op server-side timing (claim_bundle/claim_many/put_many/
        # watch fan-out): names the component that owns the ceiling —
        # plus the striped store's contention ticks and the watch-wire
        # frames/event ratio (the batching win: << 1 under burst)
        try:
            op_stats = store.op_stats()
            results["dispatch_plane_store_op_stats"] = op_stats
            frames = op_stats.get("watch_frames", {}).get("count", 0)
            events = op_stats.get("watch_events", {}).get("count", 0)
            if events:
                results["dispatch_plane_watch_frames_per_event"] = round(
                    frames / events, 4)
            results["dispatch_plane_store_stripe_contention"] = \
                op_stats.get("stripe_contention", {}).get("count", 0)
        except Exception as e:  # noqa: BLE001 — older server
            on_log(f"op_stats unavailable: {e}")
        # the RESULT plane's attribution: logd's own per-op timings,
        # plus the coalescing ratios on both ends of the record wire —
        # records per bulk RPC as logd observed them, and records per
        # flush as the agents batched them
        if rec_flushes:
            results["dispatch_plane_agent_records_per_flush"] = round(
                rec_flush_records / rec_flushes, 2)
        results["dispatch_plane_records_dropped"] = rec_dropped
        try:
            logd_stats = sink.op_stats()
            results["dispatch_plane_logd_op_stats"] = logd_stats
            bulk = logd_stats.get("create_job_logs", {}).get("count", 0)
            nrecs = logd_stats.get("log_records", {}).get("count", 0)
            if bulk:
                results["dispatch_plane_logd_records_per_batch"] = round(
                    nrecs / bulk, 2)
        except Exception as e:  # noqa: BLE001 — older logd server
            on_log(f"logd op_stats unavailable: {e}")
        if lag_p99:
            results.update({
                "dispatch_plane_exec_lag_p50_s": max(lag_p50),
                "dispatch_plane_exec_lag_p99_s": max(lag_p99),
                # the sweep offers PAST epochs (epoch0 = int(t_start)
                # - 2, "past epochs run immediately") so raw lag
                # carries a 2-3 s publication offset by construction;
                # the net figures subtract the exact offset — what
                # remains is plane latency (watch delivery, bundle
                # claim, local queueing)
                "dispatch_plane_exec_lag_offset_s": round(lag_offset, 3),
                "dispatch_plane_exec_lag_net_p50_s": round(
                    max(0.0, max(lag_p50) - lag_offset), 3),
                "dispatch_plane_exec_lag_net_p99_s": round(
                    max(0.0, max(lag_p99) - lag_offset), 3),
            })
    finally:
        for p in agents:
            p.terminate()
        for p in agents:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        store.close()
        sink.close()
        for l in logds:
            l.stop()
        for srv in store_srvs:
            srv.stop()
    return results


def run_quick(seconds=3, rate=24000, on_log=print, shards=1):
    """The agent-scaling smoke: one offered rate past a single agent's
    drain ceiling, swept at 1 then 2 agents.  Returns the two aggregate
    drain rates and their ratio — the negative-scaling regression
    gate (2 agents must drain >= 1.5x of 1) without the cost of the full
    sweep.  Meaningful only with >= 4 host cores (agents + store +
    harness each need one).

    The gate is wider than the scaling ratio: ``quick_gate_failures``
    also names a fairness collapse (min/max per-agent consumed < 0.8)
    and an unbatched watch wire (frames/event >= 1) — the two ways a
    shard-routing regression that serializes one shard shows up at
    this scale without moving the 2-over-1 ratio enough to trip it."""
    r1 = run_bench([rate], 1, seconds, on_log=on_log, shards=shards)
    r2 = run_bench([rate], 2, seconds, on_log=on_log, shards=shards)
    agg1 = r1["dispatch_plane_orders_per_sec"]
    agg2 = r2["dispatch_plane_orders_per_sec"]
    res = {
        "quick_rate_offered_per_s": rate,
        "quick_store_shards": shards,
        "agg_1_agent_per_s": agg1,
        "agg_2_agents_per_s": agg2,
        "scaling_2_over_1": round(agg2 / max(1.0, agg1), 3),
        "fairness_min_over_max_2_agents":
            r2.get("dispatch_plane_fairness_min_over_max"),
        "watch_frames_per_event":
            r2.get("dispatch_plane_watch_frames_per_event"),
        # record-plane numbers: is the result wire batched, did the
        # flushers drop anything, and how late do execs start
        "agent_records_per_flush":
            r2.get("dispatch_plane_agent_records_per_flush"),
        "logd_records_per_batch":
            r2.get("dispatch_plane_logd_records_per_batch"),
        "records_dropped": r2.get("dispatch_plane_records_dropped"),
        "exec_lag_p50_s": r2.get("dispatch_plane_exec_lag_p50_s"),
        "exec_lag_p99_s": r2.get("dispatch_plane_exec_lag_p99_s"),
        "drain_per_agent_1": r1.get(
            "dispatch_plane_drain_per_agent_per_sec"),
        "backend": r2["dispatch_plane_backend"],
    }
    failures = []
    if agg1 <= 0:
        failures.append(f"1-agent drain {agg1}/s")
    elif res["scaling_2_over_1"] < 1.5:
        failures.append(
            f"2-over-1 scaling {res['scaling_2_over_1']} < 1.5")
    fair = res["fairness_min_over_max_2_agents"]
    if fair is not None and fair < 0.8:
        failures.append(f"per-agent fairness {fair} < 0.8 — one "
                        "agent (or its shard) is serialized")
    fpe = res["watch_frames_per_event"]
    if fpe is not None and fpe >= 1.0:
        failures.append(f"watch frames/event {fpe} >= 1 — the "
                        "batched watch wire is inactive")
    res["quick_gate_failures"] = failures
    return res


def run_shard_ladder(counts, rate=40000, n_agents=2, seconds=3,
                     on_log=print):
    """The shard-count ladder: ONE past-saturation offered rate at a
    FIXED agent count, swept across store shard counts (1/2/4 by
    default).  Everything but the shard count is held still, so the
    curve isolates what partitioning the keyspace buys: aggregate
    drain must scale toward linear (the one-process WAL/event-plane/
    accept-loop ceiling is what sharding removes) while per-agent
    fairness holds — a broken routing hash shows up here as one hot
    shard and a collapsed min/max ratio.

    The ladder's scaling figure is the ORDER drain (offered orders
    over time-to-empty of the dispatch keyspace) — the coordination-
    store boundary this plane's sharding acts on.  The end-to-end
    record rate is reported beside it but is gated by the (still
    unsharded) result store's ingest: on a host where logd saturates
    first, the record figure flatlines at logd's ceiling no matter
    the shard count (sharding THAT plane is a named ROADMAP
    direction).

    Backend choice matters on ONE host: the ceiling sharding removes
    is the single-PROCESS one (one GIL/event plane/accept loop), so
    the demonstrative rungs run BENCH_STORE=py — each shard its own
    bin.store process — where that ceiling is real and low (measured
    39k -> 77k -> 127k orders/s at 1/2/4 shards, 8 native agents,
    24 cores).  The native server is already striped and
    multithreaded within one process, so a single-host native ladder
    mostly measures what CPU headroom is left after ~130k/s, not the
    partitioning win; its shard win is per-MACHINE, which one box
    cannot show."""
    ladder = []
    base = None
    backend = None
    for n in counts:
        on_log(f"=== shard ladder: {n} shard(s) ===")
        r = run_bench([rate], n_agents, seconds, on_log=on_log, shards=n)
        agg = r["dispatch_plane_order_drain_per_sec"]
        if base is None:
            base = agg
            backend = r["dispatch_plane_backend"]
        ladder.append({
            "shards": n,
            "order_drain_per_sec": agg,
            "records_per_sec": r["dispatch_plane_orders_per_sec"],
            "scaling_vs_1_shard": round(agg / max(1.0, base), 3),
            "fairness_min_over_max":
                r.get("dispatch_plane_fairness_min_over_max"),
            "watch_frames_per_event":
                r.get("dispatch_plane_watch_frames_per_event"),
            "exec_lag_net_p99_s":
                r.get("dispatch_plane_exec_lag_net_p99_s")})
    return {
        "dispatch_plane_shard_ladder_rate_offered_per_s": rate,
        "dispatch_plane_shard_ladder_agents": n_agents,
        "dispatch_plane_shard_ladder_backend": backend,
        "dispatch_plane_shard_ladder": ladder,
    }


def run_logd_ladder(counts, rate=60000, n_agents=4, seconds=3,
                    on_log=print):
    """The RESULT-plane shard ladder: one offered rate past the
    single-logd ingest ceiling at a fixed agent count, swept across
    logd shard counts (1/2/4 by default).  Everything but the logd
    shard count is held still — the store stays a single native server
    (its ~130k orders/s ceiling sits far above the record rates swept
    here), agents are whatever BENCH_AGENT says — so the curve isolates
    what partitioning the RECORD space buys: the sustained record
    drain (executions landed in the result store over time) must scale
    toward linear while zero records drop and per-agent fairness
    holds.  A broken job-routing hash shows up as one hot logd shard
    and a flat curve.

    Backend choice mirrors the store ladder's lesson: the ceiling
    sharding removes is the single-PROCESS one (one SQLite lock / one
    big store mutex), so the demonstrative rungs run BENCH_LOGD=py by
    default — each logd shard its own bin.logd process — where that
    ceiling is real and low on one host.  BENCH_LOGD=native measures
    the (already multithreaded) C++ logd instead, whose shard win is
    per-machine."""
    os.environ.setdefault("BENCH_LOGD", "py")
    ladder = []
    base = None
    backend = None
    for n in counts:
        on_log(f"=== logd shard ladder: {n} shard(s) ===")
        r = run_bench([rate], n_agents, seconds, on_log=on_log,
                      logd_shards=n)
        rec_rate = r["dispatch_plane_orders_per_sec"]
        if base is None:
            base = rec_rate
            backend = r["dispatch_plane_backend"]
        ladder.append({
            "logd_shards": n,
            "records_per_sec": rec_rate,
            "scaling_vs_1_shard": round(rec_rate / max(1.0, base), 3),
            "records_dropped": r.get("dispatch_plane_records_dropped"),
            "records_per_batch":
                r.get("dispatch_plane_logd_records_per_batch"),
            "fairness_min_over_max":
                r.get("dispatch_plane_fairness_min_over_max"),
            "exec_lag_net_p99_s":
                r.get("dispatch_plane_exec_lag_net_p99_s")})
    return {
        "result_plane_logd_ladder_rate_offered_per_s": rate,
        "result_plane_logd_ladder_agents": n_agents,
        "result_plane_logd_ladder_backend": backend,
        "result_plane_logd_ladder": ladder,
    }


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        return worker_main(sys.argv[2], sys.argv[3], sys.argv[4])
    ap = argparse.ArgumentParser()
    # the default sweep deliberately runs PAST 40k offered/s: in bundle
    # (coalesced) mode the per-agent drain ceiling was unmeasured once
    # both agents shared the ~7.7k/s legacy figure — the top rates pin
    # it (drain at/past saturation over agent count)
    ap.add_argument("--rates", default="1000,10000,40000,80000")
    ap.add_argument("--agents", type=int, default=0,
                    help="0 = auto: one per core beyond the shared "
                         "store/harness core, at least 1, at most 4")
    ap.add_argument("--agent-sweep", default="",
                    help="comma list of agent counts (e.g. 1,2,4,8); "
                         "runs the full rate sweep once per count and "
                         "reports the scaling curve — aggregate drain, "
                         "per-agent drain, fairness (VERDICT r3 #1/#6)")
    ap.add_argument("--quick", action="store_true",
                    help="negative-scaling smoke: one past-saturation "
                         "rate at 1 then 2 agents; prints the 2-over-1 "
                         "aggregate ratio (the regression gate) "
                         "plus fairness and watch frames/event — any "
                         "tripping exits nonzero")
    ap.add_argument("--shards", type=int, default=1, metavar="N",
                    help="store shard count for the sweep: N store "
                         "servers, agents and harness route by the "
                         "deterministic key hash (store/sharded.py)")
    ap.add_argument("--shard-ladder", default="",
                    help="comma list of shard counts (e.g. 1,2,4): "
                         "one past-saturation rate at --agents across "
                         "shard counts — the drain-scaling curve the "
                         "sharded store must deliver")
    ap.add_argument("--logd-shards", default="",
                    help="comma list of RESULT-store shard counts "
                         "(e.g. 1,2,4): one past-ingest-ceiling rate "
                         "at --agents across logd shard counts — the "
                         "record-drain curve the sharded result plane "
                         "must deliver (BENCH_LOGD=py per-process "
                         "shards by default)")
    ap.add_argument("--seconds", type=int, default=4)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if args.agents <= 0:
        args.agents = max(1, min(4, (os.cpu_count() or 1) - 1))
    rates = [int(r) for r in args.rates.split(",")]
    on_log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    rc = 0
    if args.quick:
        res = run_quick(seconds=min(args.seconds, 3), on_log=on_log,
                        shards=args.shards)
        if res["quick_gate_failures"]:
            on_log("QUICK GATE FAILED: "
                   + "; ".join(res["quick_gate_failures"]))
            rc = 1
    elif args.shard_ladder:
        counts = [int(c) for c in args.shard_ladder.split(",")]
        res = run_shard_ladder(counts, rate=max(rates),
                               n_agents=args.agents,
                               seconds=args.seconds, on_log=on_log)
    elif args.logd_shards:
        counts = [int(c) for c in args.logd_shards.split(",")]
        res = run_logd_ladder(counts, rate=max(rates),
                              n_agents=args.agents,
                              seconds=args.seconds, on_log=on_log)
    elif args.agent_sweep:
        counts = [int(c) for c in args.agent_sweep.split(",")]
        curve = []
        res = None
        for n in counts:
            on_log(f"=== agent sweep: {n} agent(s) ===")
            r = run_bench(rates, n, args.seconds, on_log=on_log,
                          shards=args.shards)
            curve.append({
                "agents": n,
                "sweep": r["dispatch_plane_sweep"],
                "orders_per_sec": r["dispatch_plane_orders_per_sec"],
                "drain_per_agent_per_sec":
                    r["dispatch_plane_drain_per_agent_per_sec"],
                "saturation_offered_per_sec":
                    r["dispatch_plane_saturation_offered_per_sec"],
                "fairness_min_over_max":
                    r.get("dispatch_plane_fairness_min_over_max"),
                "watch_frames_per_event":
                    r.get("dispatch_plane_watch_frames_per_event"),
                "stripe_contention":
                    r.get("dispatch_plane_store_stripe_contention")})
            if res is None:
                res = r           # single-agent fields stay top-level
        res["dispatch_plane_agent_curve"] = curve
    else:
        res = run_bench(rates, args.agents, args.seconds, on_log=on_log,
                        shards=args.shards)
    out = json.dumps(res, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    print(out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
