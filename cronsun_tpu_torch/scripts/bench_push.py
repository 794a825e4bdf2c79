"""Push-plane benchmark: M concurrent SSE viewers against live ingest.

Drives a real ApiServer (HTTP, push enabled) over native/py logd
shards, connects ``--viewers`` SSE clients to ``/v1/stream`` (raw
sockets, one selector thread — the harness must stay cheaper than the
plane it measures), and paces a writer subprocess at ``--write-rate``
records/s.  Measured:

- **publish lag** p50/p99 — record ``begin_ts`` (stamped at create) to
  client receipt, parsed from the SSE ``data:`` JSON on a sampled
  subset of viewers (parsing every event on every viewer would measure
  the harness's json.loads, not the plane)
- **connection ceiling** — viewers that completed the SSE handshake
  and were still streaming at window end (evictions show up here AND
  in ``sse_dropped_slow``)
- **bytes per viewer per second** — the fan-out wire cost
- **logd read ops** — op-counter delta over the push window vs the
  SAME freshness served by polling: a second poll phase (push
  disabled, response cache on, ``--poll-interval`` freshness) measures
  reads-per-viewer-second, extrapolated to M viewers for the ratio the
  slow gate asserts (push issues >= 10x fewer logd reads)

    python -m cronsun_tpu_torch.scripts.bench_push [--viewers M]
        [--seconds S]
        [--write-rate R] [--logd-shards N] [--poll-viewers P]
        [--poll-interval F] [--writer epoll|threads] [--json out.json]

Two more shapes ride the same harness:

- ``--quick``: a small epoll-vs-threaded differential run — exits
  NONZERO when the epoll writer under-delivers the threaded baseline
  on connected count or publish lag (the CI regression gate for the
  event-driven writer).
- ``--replicas 1,2,4``: the web-replica scale-out ladder — each rung
  spins N ApiServer subprocesses sharing nothing but the logd
  addresses, drives one viewer-fleet subprocess per replica (separate
  processes keep each side under the fd rlimit and let RSS-per-
  connection be read per replica from /proc), and reports per-replica
  + aggregate connected / lag-p99 / drop counts.  ``--out`` writes the
  git_rev-stamped PUSH_ladder.json sidecar.

Backend: native logd when the binary exists, BENCH_LOGD=py forces the
Python/SQLite server.  Run standalone or via bench.py (which merges
``push_plane_*``/``push_ladder_*`` into bench_detail.json).

Copy of ``scripts/bench_push.py`` on the port's modules: the same flags,
JSON keys and output; every child process it spawns runs
``python -m cronsun_tpu_torch.scripts.bench_push`` or a
``cronsun_tpu_torch.bin`` launcher (or ``native/``'s servers).
"""

import argparse
import json
import os
import selectors
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SELF = (sys.executable, "-m", "cronsun_tpu_torch.scripts.bench_push")

# ops that are NOT dashboard reads: ingest, the push plane itself, and
# maintenance.  Reads = everything else — robust across the native and
# python backends' differing op names, and applied identically to both
# phases so the ratio stays apples-to-apples.
_NONREAD_OPS = ("create_job_log", "create_job_logs", "log_records",
                "subscribe", "unsubscribe", "sub_events", "age_out",
                "aged_records", "auth", "trace_ingest", "trace_get")


def _pctl(xs, q):
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _read_ops(dops):
    return sum(v for k, v in dops.items()
               if v > 0 and k not in _NONREAD_OPS)


def _raise_nofile(need):
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(hard, max(soft, need))
        if want > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    except Exception:  # noqa: BLE001 — best-effort; connect errors count
        pass


class _SseViewer:
    __slots__ = ("sock", "buf", "sampled", "connected", "streaming",
                 "bytes", "events", "lost")

    def __init__(self, sock, sampled):
        self.sock = sock
        self.buf = b""
        self.sampled = sampled
        self.connected = False   # saw HTTP 200 + header terminator
        self.streaming = True
        self.bytes = 0
        self.events = 0
        self.lost = False


def _pump_viewers(sel, stop, lags, llock):
    """The viewer fleet's single reader loop: drain every readable SSE
    socket, detect the handshake, count events/bytes on all viewers
    and parse publish lag on the sampled subset."""
    now = time.time
    while not stop.is_set():
        for key, _ in sel.select(timeout=0.25):
            v = key.data
            try:
                chunk = v.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                chunk = b""
            if not chunk:
                v.streaming = False
                sel.unregister(v.sock)
                continue
            v.bytes += len(chunk)
            if not v.connected:
                v.buf += chunk
                i = v.buf.find(b"\r\n\r\n")
                if i < 0:
                    continue
                v.connected = v.buf.startswith(b"HTTP/1.") and \
                    b" 200 " in v.buf[:32]
                chunk, v.buf = v.buf[i + 4:], b""
            if v.sampled:
                v.buf += chunk
                t = now()
                while True:
                    j = v.buf.find(b"\n\n")
                    if j < 0:
                        break
                    frame, v.buf = v.buf[:j], v.buf[j + 2:]
                    if b"event: log" not in frame:
                        if b"event: lost" in frame:
                            v.lost = True
                        continue
                    v.events += 1
                    d = frame.find(b"data: ")
                    if d < 0:
                        continue
                    try:
                        ev = json.loads(
                            frame[d + 6:].split(b"\n", 1)[0])
                        with llock:
                            lags.append(
                                (t - ev["beginTime"]) * 1000.0)
                    except (ValueError, KeyError, TypeError):
                        pass
            else:
                v.events += chunk.count(b"event: log")
                if b"event: lost" in chunk:
                    v.lost = True


def _connect_fleet(host, port, viewers, sample):
    """Sequential SSE connect ramp; returns (viewers, socks, selector,
    connect_errors).  The handshake completes later, in the pump."""
    req = (f"GET /v1/stream HTTP/1.1\r\nHost: {host}\r\n"
           f"Accept: text/event-stream\r\n\r\n").encode()
    vs, socks = [], []
    sel = selectors.DefaultSelector()
    errs = 0
    for k in range(viewers):
        try:
            s = socket.create_connection((host, port), timeout=10.0)
            s.sendall(req)
            s.setblocking(False)
        except OSError:
            errs += 1
            continue
        v = _SseViewer(s, sampled=k < sample)
        vs.append(v)
        socks.append(s)
        sel.register(s, selectors.EVENT_READ, v)
        if k % 100 == 99:
            time.sleep(0.01)   # let the accept loop breathe
    return vs, socks, sel, errs


def run_push_bench(viewers=200, seconds=6.0, write_rate=50,
                   logd_shards=1, poll_viewers=8, poll_interval=1.0,
                   sample=64, sse_writer=None, on_log=print):
    from ..logsink import LogRecord
    from ..logsink.native import find_binary as find_logd
    from ..logsink.native import NativeLogSinkServer
    from ..logsink.sharded import connect_sharded_sink
    from ..store.memstore import MemStore
    from ..web.server import ApiServer, NotModified
    from .bench_dispatch import _PyLogShardServer

    viewers = max(1, viewers)
    logd_shards = max(1, logd_shards)
    _raise_nofile(2 * viewers + 512)
    logd_bin = (None if os.environ.get("BENCH_LOGD") == "py"
                else find_logd())
    backend = ("native-logd" if logd_bin else "py-logd") + (
        f"x{logd_shards}-shards" if logd_shards > 1 else "")
    tmpdir = tempfile.mkdtemp(prefix="bench_push_")
    logds, socks = [], []
    sink = web = web_poll = wproc = None
    try:
        for si in range(logd_shards):
            if logd_bin:
                logds.append(NativeLogSinkServer(
                    binary=logd_bin,
                    db=os.path.join(tmpdir, f"p{si}.wal")))
            else:
                logds.append(_PyLogShardServer(
                    ("--db", os.path.join(tmpdir, f"p{si}.db"))))
        addrs = [f"{l.host}:{l.port}" for l in logds]
        sink = connect_sharded_sink(addrs)
        seed = [LogRecord(job_id=f"pj{i % 16}", job_group="p",
                          name=f"push-bench-{i % 16}", node=f"pn{i % 4}",
                          user="", command="true", output="seed",
                          success=True, begin_ts=time.time(),
                          end_ts=time.time()) for i in range(200)]
        sink.create_job_logs(seed)

        web = ApiServer(MemStore(), sink, auth_enabled=False,
                        cache_enabled=True, port=0, push_enabled=True,
                        sse_writer=sse_writer).start()
        if web._push is None or not web._push.running:
            raise RuntimeError("push plane failed to start "
                               "(backend lacks subscribe?)")
        on_log(f"web up on :{web.port} ({backend}, {web.sse_writer} "
               f"writer); connecting {viewers} SSE viewers")

        # ---- connect ramp (sequential: a clean ceiling count) ----
        vs, socks, sel, connect_errs = _connect_fleet(
            web.host, web.port, viewers, sample)

        lags = []
        llock = threading.Lock()
        stop = threading.Event()
        pt = threading.Thread(target=_pump_viewers,
                              args=(sel, stop, lags, llock),
                              daemon=True, name="sse-pump")
        pt.start()
        deadline = time.time() + 3.0
        while (time.time() < deadline
               and sum(1 for v in vs if v.connected) < len(vs)):
            time.sleep(0.05)
        n_conn = sum(1 for v in vs if v.connected)
        on_log(f"{n_conn}/{viewers} viewers streaming "
               f"({connect_errs} connect errors)")

        def ops_counts():
            try:
                return {k: x["count"] for k, x in sink.op_stats().items()}
            except Exception:  # noqa: BLE001 — older server
                return {}

        # ---- measured push window (ingest via its own process: the
        # harness's selector loop is GIL-hungry enough that an in-harness
        # writer would pace itself, not the plane) ----
        ops0 = ops_counts()
        wproc = subprocess.Popen(
            [*SELF, "--writer-mode",
             "--writer-addrs", ",".join(addrs),
             "--write-rate", str(write_rate)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=ROOT)
        wrote = [0]

        def writer_counts():
            for line in wproc.stdout:
                parts = line.split()
                if len(parts) == 2 and parts[0] == "W":
                    wrote[0] = int(parts[1])
        wt = threading.Thread(target=writer_counts, daemon=True)
        wt.start()
        t0 = time.time()
        time.sleep(seconds)
        elapsed = time.time() - t0
        wrote_window = wrote[0]   # the writer keeps driving the poll
        ops1 = ops_counts()       # phase; this metric is window-only
        push_stats = web._push.stats()
        alive = sum(1 for v in vs if v.connected and v.streaming
                    and not v.lost)
        total_bytes = sum(v.bytes for v in vs)
        total_events = sum(v.events for v in vs)
        # window cost only: subtract the handshake-time snapshot noise
        # by measuring ops strictly inside [ops0, ops1]
        push_dops = {k: ops1.get(k, 0) - ops0.get(k, 0)
                     for k in set(ops0) | set(ops1)}
        push_reads = _read_ops(push_dops)

        # ---- teardown viewers before the poll phase ----
        stop.set()
        pt.join(timeout=10)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        with llock:
            lag_list = list(lags)

        # ---- poll baseline at the same freshness: a push-disabled
        # ApiServer over the SAME sink (in-process dispatch — no HTTP
        # socket cost in the poll numbers), P pollers carrying
        # If-None-Match at --poll-interval, writer still running ----
        prev = os.environ.get("CRONSUN_WEB_PUSH")
        os.environ["CRONSUN_WEB_PUSH"] = "off"
        try:
            web_poll = ApiServer(MemStore(), sink, auth_enabled=False,
                                 cache_enabled=True)
        finally:
            if prev is None:
                os.environ.pop("CRONSUN_WEB_PUSH", None)
            else:
                os.environ["CRONSUN_WEB_PUSH"] = prev
        poll_secs = min(seconds, 4.0)
        pstop = threading.Event()
        pcounts = {"polls": 0, "nm": 0, "bytes": 0, "errors": 0}
        plock = threading.Lock()

        def poller(k):
            etag = None
            q = {"latest": "true", "pageSize": "500"}
            time.sleep((k / max(1, poll_viewers)) * poll_interval)
            while not pstop.is_set():
                hdr = {"If-None-Match": etag} if etag else {}
                try:
                    r, ctx = web_poll.handle("GET", "/v1/logs", q, b"",
                                             {}, hdr)
                    etag = ctx.out_headers.get("ETag", etag)
                    body = len(json.dumps(r, separators=(",", ":")))
                    with plock:
                        pcounts["polls"] += 1
                        pcounts["bytes"] += body + 150
                except NotModified:
                    with plock:
                        pcounts["polls"] += 1
                        pcounts["nm"] += 1
                        pcounts["bytes"] += 150
                except Exception:  # noqa: BLE001 — counted
                    with plock:
                        pcounts["errors"] += 1
                pstop.wait(poll_interval)

        ops2 = ops_counts()
        pts = [threading.Thread(target=poller, args=(k,), daemon=True)
               for k in range(max(1, poll_viewers))]
        pt0 = time.time()
        for t in pts:
            t.start()
        time.sleep(poll_secs)
        pstop.set()
        for t in pts:
            t.join(timeout=10)
        poll_elapsed = time.time() - pt0
        ops3 = ops_counts()
        wproc.terminate()
        try:
            wproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            wproc.kill()
        poll_dops = {k: ops3.get(k, 0) - ops2.get(k, 0)
                     for k in set(ops2) | set(ops3)}
        poll_reads = _read_ops(poll_dops)

        pv = max(1, poll_viewers)
        push_rps = push_reads / max(1, n_conn) / elapsed
        poll_rps = poll_reads / pv / poll_elapsed
        # the gate's number: poll reads extrapolated to the SAME viewer
        # fleet over the push window, vs what push actually issued
        poll_equiv = poll_rps * max(1, n_conn) * elapsed
        ratio = poll_equiv / max(1.0, float(push_reads))
        res = {
            "push_plane_backend": backend,
            "push_plane_sse_writer": web.sse_writer,
            "push_plane_logd_shards": logd_shards,
            "push_plane_viewers": viewers,
            "push_plane_viewers_connected": n_conn,
            "push_plane_viewers_alive_at_end": alive,
            "push_plane_connect_errors": connect_errs,
            "push_plane_seconds": round(elapsed, 2),
            "push_plane_write_rate_target": write_rate,
            "push_plane_write_records_per_s": round(
                wrote_window / elapsed, 1),
            "push_plane_publish_lag_p50_ms": round(_pctl(lag_list, 0.50), 2),
            "push_plane_publish_lag_p99_ms": round(_pctl(lag_list, 0.99), 2),
            "push_plane_lag_samples": len(lag_list),
            "push_plane_events_per_viewer_s": round(
                total_events / max(1, n_conn) / elapsed, 1),
            "push_plane_bytes_per_viewer_s": round(
                total_bytes / max(1, n_conn) / elapsed, 1),
            "push_plane_sse_events_total": push_stats.get("events_total", 0),
            "push_plane_sse_dropped_slow": push_stats.get(
                "dropped_slow_total", 0),
            "push_plane_read_ops": push_reads,
            "push_plane_read_ops_per_viewer_s": round(push_rps, 4),
            "push_plane_poll_viewers": pv,
            "push_plane_poll_interval_s": poll_interval,
            "push_plane_poll_read_ops": poll_reads,
            "push_plane_poll_read_ops_per_viewer_s": round(poll_rps, 4),
            "push_plane_poll_304_rate": round(
                pcounts["nm"] / max(1, pcounts["polls"]), 3),
            "push_plane_poll_bytes_per_viewer_s": round(
                pcounts["bytes"] / pv / poll_elapsed, 1),
            "push_plane_poll_errors": pcounts["errors"],
            "push_plane_read_op_ratio": round(ratio, 1),
        }
        on_log(f"viewers={n_conn} lag p50={res['push_plane_publish_lag_p50_ms']}ms "
               f"p99={res['push_plane_publish_lag_p99_ms']}ms "
               f"bytes/viewer/s={res['push_plane_bytes_per_viewer_s']} "
               f"reads push={push_reads} poll~{round(poll_equiv)} "
               f"(ratio {res['push_plane_read_op_ratio']}x)")
        return res
    finally:
        if wproc is not None and wproc.poll() is None:
            wproc.kill()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for w in (web, web_poll):
            if w is not None:
                try:
                    w.stop()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
        if sink is not None:
            try:
                sink.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for l in logds:
            try:
                l.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        shutil.rmtree(tmpdir, ignore_errors=True)


def _rss_kb(pid: int) -> int:
    """VmRSS of a process in KiB (0 when unreadable)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


def _bench_git_rev() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10,
            cwd=ROOT)
        return out.stdout.strip() or "unknown"
    except Exception:  # noqa: BLE001 — not a git checkout
        return "unknown"


def _read_child_line(proc, prefix: str, timeout: float):
    """Next stdout line starting with ``prefix`` from a child, bounded;
    None on timeout/death (the caller counts the replica out)."""
    import select as _select
    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = _select.select([proc.stdout], [], [], 0.5)
        if r:
            line = proc.stdout.readline()
            if not line:
                return None
            line = line.strip()
            if line.startswith(prefix):
                return line
        elif proc.poll() is not None:
            return None
    return None


def _scrape_sse_stats(port: int) -> dict:
    """The replica's unlabeled cronsun_web_sse_* series off
    /v1/metrics — server-side drop/eviction/loop-lag truth the viewer
    fleet can't observe from its end of the socket."""
    import urllib.request
    out = {}
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/metrics", timeout=10
        ).read().decode()
    except Exception:  # noqa: BLE001 — replica died; counted elsewhere
        return out
    for line in text.splitlines():
        if not line.startswith("cronsun_web_sse_") or "{" in line:
            continue
        try:
            name, val = line.split()
            out[name[len("cronsun_web_sse_"):]] = float(val)
        except ValueError:
            continue
    return out


def serve_main(addrs: str, writer: str, nofile: int) -> int:
    """One web replica as its own process: an ApiServer (push on) over
    the shared logd addresses.  Prints ``PORT <p>`` once up, serves
    until ``STOP`` (or EOF) on stdin.  Share-nothing by construction —
    the only thing replicas have in common is ``addrs``."""
    from ..logsink.sharded import connect_sharded_sink
    from ..store.memstore import MemStore
    from ..web.server import ApiServer
    _raise_nofile(nofile)
    sink = connect_sharded_sink(addrs.split(","))
    web = ApiServer(MemStore(), sink, auth_enabled=False,
                    cache_enabled=True, port=0, push_enabled=True,
                    sse_writer=writer or None).start()
    if web._push is None or not web._push.running:
        print("ERR push unavailable", flush=True)
        return 1
    print(f"PORT {web.port}", flush=True)
    try:
        for line in sys.stdin:
            if line.strip() == "STOP":
                break
    except KeyboardInterrupt:
        pass
    web.stop()
    sink.close()
    return 0


def viewer_main(port: int, viewers: int, sample: int) -> int:
    """One replica's viewer fleet as its own process (the fd budget:
    10k server sockets + 10k client sockets can't share one process
    under a 20k RLIMIT_NOFILE).  Connects, prints ``READY <n>``, pumps
    until ``STOP``/EOF on stdin, then prints ``RESULT <json>``."""
    _raise_nofile(viewers + 512)
    vs, socks, sel, errs = _connect_fleet("127.0.0.1", port, viewers,
                                          sample)
    lags = []
    llock = threading.Lock()
    stop = threading.Event()
    pt = threading.Thread(target=_pump_viewers,
                          args=(sel, stop, lags, llock),
                          daemon=True, name="sse-pump")
    pt.start()
    deadline = time.time() + 10.0 + viewers * 0.005
    while (time.time() < deadline
           and sum(1 for v in vs if v.connected) < len(vs)):
        time.sleep(0.05)
    n_conn = sum(1 for v in vs if v.connected)
    print(f"READY {n_conn}", flush=True)
    try:
        for line in sys.stdin:
            if line.strip() == "STOP":
                break
    except KeyboardInterrupt:
        pass
    stop.set()
    pt.join(timeout=10)
    with llock:
        lag_list = list(lags)
    if len(lag_list) > 8000:     # bounded child->harness payload
        lag_list = lag_list[::len(lag_list) // 8000 + 1]
    res = {
        "connected": n_conn,
        "alive": sum(1 for v in vs if v.connected and v.streaming
                     and not v.lost),
        "lost": sum(1 for v in vs if v.lost),
        "connect_errors": errs,
        "events": sum(v.events for v in vs),
        "bytes": sum(v.bytes for v in vs),
        "lags": [round(x, 3) for x in lag_list],
    }
    print("RESULT " + json.dumps(res), flush=True)
    for s in socks:
        try:
            s.close()
        except OSError:
            pass
    return 0


def run_replica_ladder(replicas, viewers_per_replica=200, seconds=5.0,
                       write_rate=20, logd_shards=1, sample=64,
                       sse_writer=None, on_log=print):
    """The web-replica scale-out ladder: for each rung, N serve-mode
    subprocesses share only the logd addresses, one viewer-mode
    subprocess per replica drives its fleet, and one paced writer
    feeds the shared sink.  Reports per-replica and aggregate
    connected / lag / drop counts plus RSS-per-connection read from
    each replica's /proc — the share-nothing scale-out claim, benched
    rather than asserted."""
    from ..logsink import LogRecord
    from ..logsink.native import find_binary as find_logd
    from ..logsink.native import NativeLogSinkServer
    from ..logsink.sharded import connect_sharded_sink
    from .bench_dispatch import _PyLogShardServer

    replicas = sorted(set(max(1, int(r)) for r in replicas))
    logd_shards = max(1, logd_shards)
    logd_bin = (None if os.environ.get("BENCH_LOGD") == "py"
                else find_logd())
    backend = ("native-logd" if logd_bin else "py-logd") + (
        f"x{logd_shards}-shards" if logd_shards > 1 else "")
    tmpdir = tempfile.mkdtemp(prefix="bench_pushladder_")
    logds = []
    sink = None
    rungs = []
    try:
        for si in range(logd_shards):
            if logd_bin:
                logds.append(NativeLogSinkServer(
                    binary=logd_bin,
                    db=os.path.join(tmpdir, f"p{si}.wal")))
            else:
                logds.append(_PyLogShardServer(
                    ("--db", os.path.join(tmpdir, f"p{si}.db"))))
        addrs = [f"{l.host}:{l.port}" for l in logds]
        sink = connect_sharded_sink(addrs)
        t = time.time()
        sink.create_job_logs([
            LogRecord(job_id=f"pj{i % 16}", job_group="p",
                      name=f"push-bench-{i % 16}", node=f"pn{i % 4}",
                      user="", command="true", output="seed",
                      success=True, begin_ts=t, end_ts=t)
            for i in range(200)])

        for nrep in replicas:
            on_log(f"rung {nrep} replica(s) x {viewers_per_replica} "
                   f"viewers ({backend})")
            serve_procs, viewer_procs = [], []
            wproc = None
            try:
                ports = []
                for _ in range(nrep):
                    p = subprocess.Popen(
                        [*SELF, "--serve-mode",
                         "--serve-addrs", ",".join(addrs),
                         "--writer", sse_writer or "",
                         "--nofile", str(viewers_per_replica + 2048)],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                        stderr=subprocess.DEVNULL, text=True, cwd=ROOT)
                    serve_procs.append(p)
                    line = _read_child_line(p, "PORT ", 60.0)
                    if line is None:
                        raise RuntimeError("replica failed to start")
                    ports.append(int(line.split()[1]))
                rss0 = [_rss_kb(p.pid) for p in serve_procs]
                for port in ports:
                    vp = subprocess.Popen(
                        [*SELF, "--viewer-mode",
                         "--viewer-port", str(port),
                         "--viewers", str(viewers_per_replica),
                         "--sample", str(sample)],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                        stderr=subprocess.DEVNULL, text=True, cwd=ROOT)
                    viewer_procs.append(vp)
                readys = []
                ramp_budget = 60.0 + viewers_per_replica * 0.02
                for vp in viewer_procs:
                    line = _read_child_line(vp, "READY ", ramp_budget)
                    readys.append(0 if line is None
                                  else int(line.split()[1]))
                rss1 = [_rss_kb(p.pid) for p in serve_procs]

                # ---- measured window ----
                wproc = subprocess.Popen(
                    [*SELF, "--writer-mode",
                     "--writer-addrs", ",".join(addrs),
                     "--write-rate", str(write_rate)],
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL, cwd=ROOT)
                t0 = time.time()
                time.sleep(seconds)
                elapsed = time.time() - t0
                stats = [_scrape_sse_stats(port) for port in ports]
                for vp in viewer_procs:
                    try:
                        vp.stdin.write("STOP\n")
                        vp.stdin.flush()
                    except OSError:
                        pass
                results = []
                for vp in viewer_procs:
                    line = _read_child_line(vp, "RESULT ", 30.0)
                    results.append(
                        json.loads(line[len("RESULT "):])
                        if line else {})
            finally:
                if wproc is not None:
                    wproc.terminate()
                    try:
                        wproc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        wproc.kill()
                for p in viewer_procs + serve_procs:
                    try:
                        p.stdin.close()
                    except OSError:
                        pass
                for p in viewer_procs + serve_procs:
                    try:
                        p.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        p.kill()

            lag_all = [x for r in results for x in r.get("lags", [])]
            connected = [r.get("connected", 0) for r in results]
            rss_per_conn = [
                round((b - a) / c, 1) if c > 0 else 0.0
                for a, b, c in zip(rss0, rss1, connected)]
            rung = {
                "replicas": nrep,
                "viewers_per_replica": viewers_per_replica,
                "connected": connected,
                "connected_aggregate": sum(connected),
                "alive_aggregate": sum(r.get("alive", 0)
                                       for r in results),
                "lost": sum(r.get("lost", 0) for r in results),
                "connect_errors": sum(r.get("connect_errors", 0)
                                      for r in results),
                "events_aggregate": sum(r.get("events", 0)
                                        for r in results),
                "seconds": round(elapsed, 2),
                "lag_p50_ms": round(_pctl(lag_all, 0.50), 2),
                "lag_p99_ms": round(_pctl(lag_all, 0.99), 2),
                "lag_samples": len(lag_all),
                "sse_dropped_slow": sum(
                    s.get("dropped_slow_total", 0) for s in stats),
                "sse_ring_evictions": sum(
                    s.get("ring_evictions_total", 0) for s in stats),
                "sse_loop_lag_p99_ms": max(
                    [s.get("loop_lag_p99_ms", 0.0) for s in stats]
                    or [0.0]),
                "rss_per_conn_kb": rss_per_conn,
            }
            rungs.append(rung)
            on_log(f"  connected {sum(connected)}/"
                   f"{nrep * viewers_per_replica} "
                   f"lag p99={rung['lag_p99_ms']}ms "
                   f"drops={rung['sse_dropped_slow']} "
                   f"rss/conn={rss_per_conn}KiB")

        res = {
            "push_ladder_backend": backend,
            "push_ladder_sse_writer": sse_writer or "epoll",
            "push_ladder_viewers_per_replica": viewers_per_replica,
            "push_ladder_write_rate": write_rate,
            "push_ladder": rungs,
        }
        base = next((r for r in rungs if r["replicas"] == 1), None)
        for r in rungs:
            if base is None or r is base or \
                    base["connected_aggregate"] == 0:
                continue
            k = r["replicas"]
            res[f"push_ladder_{k}x_connected_ratio"] = round(
                r["connected_aggregate"]
                / base["connected_aggregate"], 2)
            res[f"push_ladder_{k}x_lag_ratio"] = round(
                r["lag_p99_ms"] / max(base["lag_p99_ms"], 1e-9), 2)
        return res
    finally:
        if sink is not None:
            try:
                sink.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for l in logds:
            try:
                l.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        shutil.rmtree(tmpdir, ignore_errors=True)


def writer_main(addrs: str, write_rate: int) -> int:
    """Paced ingest as its own process: ``write_rate`` records/s in
    10 Hz beats, ``begin_ts`` stamped at creation (the publish-lag
    clock source), reporting "W <wrote>" per beat."""
    from ..logsink import LogRecord
    from ..logsink.sharded import connect_sharded_sink
    sink = connect_sharded_sink(addrs.split(","))
    rate = max(1, write_rate)
    wrote = 0
    t_start = time.time()
    while True:
        target = int((time.time() - t_start) * rate)
        n = target - wrote
        if n <= 0:
            time.sleep(0.02)
            continue
        t = time.time()
        batch = [LogRecord(job_id=f"pj{(wrote + k) % 16}", job_group="p",
                           name=f"push-bench-{(wrote + k) % 16}",
                           node=f"pn{(wrote + k) % 4}", user="",
                           command="true", output="bench",
                           success=(wrote + k) % 7 != 0,
                           begin_ts=t, end_ts=t)
                 for k in range(min(n, 500))]
        try:
            sink.create_job_logs(batch)
            wrote += len(batch)
        except Exception:  # noqa: BLE001 — keep driving
            time.sleep(0.1)
        print(f"W {wrote}", flush=True)


def quick_compare(args, on_log) -> int:
    """The CI regression gate: a small epoll run vs the threaded
    baseline on the same knobs.  Exit nonzero when epoll under-
    delivers on connected count or publish lag (1.5x + 150 ms slack —
    small-run lag percentiles on a loaded CPU host are noisy, but a
    regression that matters blows through both)."""
    res = {}
    for mode in ("epoll", "threads"):
        on_log(f"quick compare: {mode} writer")
        res[mode] = run_push_bench(
            viewers=args.viewers, seconds=args.seconds,
            write_rate=args.write_rate, logd_shards=args.logd_shards,
            poll_viewers=args.poll_viewers,
            poll_interval=args.poll_interval, sse_writer=mode,
            on_log=on_log)
    e, t = res["epoll"], res["threads"]
    conn_ok = (e["push_plane_viewers_connected"]
               >= t["push_plane_viewers_connected"])
    lag_ok = (e["push_plane_publish_lag_p99_ms"]
              <= 1.5 * t["push_plane_publish_lag_p99_ms"] + 150.0)
    out = {
        "push_quick_epoll_connected": e["push_plane_viewers_connected"],
        "push_quick_threads_connected":
            t["push_plane_viewers_connected"],
        "push_quick_epoll_lag_p99_ms":
            e["push_plane_publish_lag_p99_ms"],
        "push_quick_threads_lag_p99_ms":
            t["push_plane_publish_lag_p99_ms"],
        "push_quick_ok": bool(conn_ok and lag_ok),
    }
    text = json.dumps(out, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    if not conn_ok:
        on_log("GATE FAIL: epoll connected below threaded baseline")
    if not lag_ok:
        on_log("GATE FAIL: epoll publish lag regressed vs threaded")
    return 0 if (conn_ok and lag_ok) else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--viewers", type=int, default=200,
                    help="SSE viewers (per replica in ladder mode)")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--write-rate", type=int, default=50,
                    help="paced ingest records/s during the window")
    ap.add_argument("--logd-shards", type=int, default=1)
    ap.add_argument("--poll-viewers", type=int, default=8,
                    help="pollers in the comparison phase (rate is "
                         "extrapolated to --viewers for the ratio)")
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="poll freshness the ratio compares against")
    ap.add_argument("--writer", default="",
                    choices=["", "epoll", "threads"],
                    help="SSE writer mode (default: server default)")
    ap.add_argument("--sample", type=int, default=64,
                    help="viewers whose frames are parsed for lag")
    ap.add_argument("--quick", action="store_true",
                    help="small epoll-vs-threads compare; exits "
                         "nonzero when epoll under-delivers")
    ap.add_argument("--replicas", default="",
                    help="comma ladder (e.g. 1,2,4): web-replica "
                         "scale-out bench instead of the single run")
    ap.add_argument("--out", default=None,
                    help="replica-ladder sidecar path (git_rev-"
                         "stamped, like MULTICHIP_ladder.json)")
    ap.add_argument("--json", default=None)
    # internal: the subprocess personalities this harness spawns
    ap.add_argument("--writer-mode", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--writer-addrs", default="", help=argparse.SUPPRESS)
    ap.add_argument("--serve-mode", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-addrs", default="", help=argparse.SUPPRESS)
    ap.add_argument("--nofile", type=int, default=4096,
                    help=argparse.SUPPRESS)
    ap.add_argument("--viewer-mode", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--viewer-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.writer_mode:
        return writer_main(args.writer_addrs, args.write_rate)
    if args.serve_mode:
        return serve_main(args.serve_addrs, args.writer, args.nofile)
    if args.viewer_mode:
        return viewer_main(args.viewer_port, args.viewers, args.sample)
    on_log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    if args.quick:
        return quick_compare(args, on_log)
    if args.replicas:
        reps = [int(x) for x in args.replicas.split(",") if x.strip()]
        res = run_replica_ladder(
            reps, viewers_per_replica=args.viewers,
            seconds=args.seconds, write_rate=args.write_rate,
            logd_shards=args.logd_shards, sample=args.sample,
            sse_writer=args.writer or None, on_log=on_log)
        res["git_rev"] = _bench_git_rev()
        res["generated_at_utc"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        out = json.dumps(res, indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out)
        if args.json:
            with open(args.json, "w") as f:
                f.write(out)
        print(out)
        return 0
    res = run_push_bench(viewers=args.viewers, seconds=args.seconds,
                         write_rate=args.write_rate,
                         logd_shards=args.logd_shards,
                         poll_viewers=args.poll_viewers,
                         poll_interval=args.poll_interval,
                         sample=args.sample,
                         sse_writer=args.writer or None,
                         on_log=on_log)
    out = json.dumps(res, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
