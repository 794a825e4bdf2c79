"""Result-store server — the rebuild's MongoDB.

    python -m cronsun_tpu_torch.bin.logd [--db FILE] [--host H] [--port P]
                                   [--token T] [--conf F] [--native]

Serves execution logs, latest-status, stats, the node-liveness mirror
and accounts (reference collections in db/mgo.go, job_log.go) over TCP
so agents, web servers and noticers on DIFFERENT machines share one
result store.  With --native the C++ server (native/logd.cc) serves
instead of the Python/SQLite one: same wire protocol and semantics
(tests/test_logsink_remote.py runs the conformance suite against both),
in-memory tables + WAL, bounded retention.  Single-machine deployments
can skip this process and point every entrypoint at the same ``log_db``
file instead.

Copy of ``cronsun_tpu/bin/logd.py``.
"""

from __future__ import annotations

import sys

from .. import events, log
from ..logsink import LogSinkServer
from .common import base_parser, server_tls, setup_common


def main(argv=None) -> int:
    ap = base_parser(__doc__, store_required=False)
    ap.add_argument("--db", default=None, metavar="FILE",
                    help="SQLite file (Python) / WAL file (--native); "
                         "default: conf log_db")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7078)
    ap.add_argument("--token", default=None,
                    help="shared secret clients must present "
                         "(default: conf log_token)")
    ap.add_argument("--native", action="store_true",
                    help="serve with the native C++ result store")
    ap.add_argument("--retain", type=int, default=None,
                    help="execution-history retention cap in records, "
                         ">= 1 (stats/latest-status stay exact); "
                         "default: native 1M, Python unbounded")
    ap.add_argument("--hot-days", type=int, default=0, metavar="D",
                    help="tiered retention: keep D whole UTC days of "
                         "records HOT (in memory / SQL); older days age "
                         "into immutable per-day segment files "
                         "(FILE.segs/<day>.seg) the history queries "
                         "merge back in.  0 (default) = no day aging; "
                         "CRONSUN_TIERING=off also disables the hot "
                         "read mirrors entirely")
    ap.add_argument("--health-port", type=int, default=0, metavar="P",
                    help="serve /healthz + /readyz on this port "
                         "(readiness: every shard accepting TCP + the "
                         "WAL/DB directory writable; 0 disables)")
    ap.add_argument("--shards", type=int, default=1, metavar="N",
                    help="serve a RESULT-PLANE SHARD SET: N logd "
                         "servers on ports port..port+N-1, each with "
                         "its own DB/WAL sidecar (FILE.s<i>) — clients "
                         "connect with the comma-joined address list "
                         "and route by the deterministic job hash "
                         "(logsink/sharded.py)")
    args = ap.parse_args(argv)
    if args.retain is not None and args.retain < 1:
        # 0 would mean "unbounded" to the SQLite store but "keep
        # nothing" to the native one — refuse the ambiguity
        print("error: --retain must be >= 1 (omit it for the default)",
              file=sys.stderr)
        return 2
    if args.shards < 1:
        ap.error(f"--shards must be >= 1 (got {args.shards})")
    if args.hot_days < 0:
        ap.error(f"--hot-days must be >= 0 (got {args.hot_days})")
    cfg, ks, watcher = setup_common(args)
    token = cfg.log_token if args.token is None else args.token

    sslctx = server_tls(cfg.log_tls, args.native, "cronsun-logd")
    rc = [0]
    servers = []
    db_base = args.db or cfg.log_db

    def shard_db(i):
        # N=1 keeps the plain FILE name (and an existing pre-shard DB);
        # :memory: stays :memory: — each server owns its own anyway
        if args.shards == 1 or db_base == ":memory:":
            return db_base
        return f"{db_base}.s{i}"

    def shard_port(i):
        # --port 0 = ephemeral: every shard picks its own free port
        # (0+i would try to bind fixed low ports); the READY line
        # carries the actual bound addresses either way
        return args.port + i if args.port else 0

    if args.native:
        from ..logsink.native import NativeLogSinkServer

        def child_died(code: int):
            # don't sit healthy-looking in front of a dead result store
            log.errorf("native logd exited rc=%d; shutting down", code)
            rc[0] = code if code > 0 else 1
            events.shutdown()
        for i in range(args.shards):
            srv = NativeLogSinkServer(host=args.host, port=shard_port(i),
                                      db=shard_db(i), retain=args.retain,
                                      hot_days=args.hot_days or None,
                                      token=token).start()
            srv.monitor(child_died)
            servers.append(srv)
    else:
        for i in range(args.shards):
            servers.append(LogSinkServer(db_path=shard_db(i),
                                         host=args.host,
                                         port=shard_port(i),
                                         token=token, sslctx=sslctx,
                                         retain=args.retain or 0,
                                         hot_days=args.hot_days).start())
    addrs = ",".join(f"{s.host}:{s.port}" for s in servers)
    if args.shards == 1:
        log.infof("cronsun-logd serving on %s (db %s)%s", addrs, db_base,
                  " (tls)" if sslctx is not None else "")
    else:
        log.infof("cronsun-logd serving %d shards on %s (db %s.s<i>)%s",
                  args.shards, addrs, db_base,
                  " (tls)" if sslctx is not None else "")
    print(f"READY {addrs}", flush=True)
    if args.health_port:
        from ..health import HealthServer, tcp_accept_check, \
            wal_writable_check
        checks = {"wal": wal_writable_check(
            None if db_base == ":memory:" else db_base)}
        for i, s in enumerate(servers):
            checks[f"shard{i}"] = tcp_accept_check(s.host, s.port)
        health = HealthServer(checks, port=args.health_port).start()
        events.on(events.EXIT, health.stop)
    for s in servers:
        events.on(events.EXIT, s.stop)
    if watcher:
        events.on(events.EXIT, watcher.stop)
    events.wait()
    return rc[0]


if __name__ == "__main__":
    sys.exit(main())
