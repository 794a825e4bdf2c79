"""Coordination store server — the rebuild's etcd.

    python -m cronsun_tpu_torch.bin.store [--host H] [--port P] [--conf F]
                                    [--native]

With --native the C++ server (native/stored.cc) serves instead of the
Python one: same wire protocol and semantics (the conformance suite in
tests/test_remote_store.py runs against both), no GIL, O(log n) prefix
scans — the production choice.

Copy of ``cronsun_tpu/bin/store.py``.
"""

from __future__ import annotations

import sys

from .. import events, log
from ..store.remote import StoreServer
from .common import base_parser, server_tls, setup_common


def main(argv=None) -> int:
    ap = base_parser(__doc__, store_required=False)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7070)
    ap.add_argument("--native", action="store_true",
                    help="serve with the native C++ store")
    ap.add_argument("--wal", default=None, metavar="FILE",
                    help="write-ahead log + snapshot sidecar (FILE and "
                         "FILE.snap): state survives restarts; boot is "
                         "load-snapshot + replay-tail (both backends)")
    ap.add_argument("--compact-wal-bytes", type=int, default=-1,
                    metavar="N",
                    help="snapshot + truncate the WAL once it exceeds N "
                         "bytes — bounds restart replay by snapshot "
                         "cadence (default: backend default, 256 MiB; "
                         "0 disables size-triggered compaction)")
    ap.add_argument("--token", default=None,
                    help="shared secret clients must present "
                         "(default: conf store_token)")
    ap.add_argument("--stripes", type=int, default=0,
                    help="keyspace lock stripes (0 = backend default, "
                         "16); more stripes = more concurrent writers "
                         "before lock contention")
    ap.add_argument("--snapshot-staggered", choices=("on", "off"),
                    default="on",
                    help="snapshot imaging: 'on' (default) images "
                         "stripes one at a time under their own locks "
                         "against a pinned revision (copy-on-write side "
                         "buffers; writers stall at most one stripe's "
                         "copy); 'off' = the full-lock hold (rollback)")
    ap.add_argument("--shards", type=int, default=1, metavar="N",
                    help="serve a SHARD SET: N store servers on ports "
                         "port..port+N-1, each with its own WAL "
                         "(FILE.s<i>) — clients connect with the "
                         "comma-joined address list and route by the "
                         "deterministic key hash (store/sharded.py)")
    ap.add_argument("--health-port", type=int, default=0, metavar="P",
                    help="serve /healthz + /readyz on this port "
                         "(readiness: every shard accepting TCP + the "
                         "WAL directory writable; on a replica the "
                         "'leader' check 503s followers; 0 disables)")
    ap.add_argument("--repl-group", default="", metavar="A1|A2|A3",
                    help="replication plane (repl/): serve as ONE "
                         "member of this '|'-joined replica group "
                         "(every member lists the same group).  Member "
                         "0 boots as leader, the rest as followers "
                         "shipping the WAL record stream; requires "
                         "--shards 1 (replicate each shard as its own "
                         "process/group)")
    ap.add_argument("--repl-self", default="", metavar="HOST:PORT",
                    help="this server's own address within "
                         "--repl-group (default: the bound host:port)")
    ap.add_argument("--repl-ack", choices=("async", "quorum"),
                    default="async",
                    help="'async' (default): client writes ack after "
                         "the leader's local apply — today's latency, "
                         "single-copy durability until shipped; "
                         "'quorum': acks wait for >= 1 follower to "
                         "hold the write, so an acked write survives "
                         "losing the leader")
    ap.add_argument("--repl-promote-after", type=float, default=3.0,
                    metavar="S",
                    help="follower takeover grace: promote after the "
                         "leader has been unreachable this long "
                         "(default 3s)")
    args = ap.parse_args(argv)
    if args.shards < 1:
        ap.error(f"--shards must be >= 1 (got {args.shards})")
    if args.repl_group:
        members = [m.strip() for m in args.repl_group.split("|")]
        if any(not m for m in members) or not members:
            ap.error(f"--repl-group {args.repl_group!r} has an empty "
                     "member (want addr1|addr2|...)")
        if args.shards != 1:
            ap.error("--repl-group requires --shards 1: replicate a "
                     "shard set by launching each shard as its own "
                     "replica-group process set")
    cfg, ks, watcher = setup_common(args)

    token = cfg.store_token if args.token is None else args.token
    sslctx = server_tls(cfg.store_tls, args.native, "cronsun-store")
    if args.repl_group and args.native:
        # the native server does not speak the repl_* wire ops yet —
        # refuse loudly (ROADMAP: "native stored.cc replication
        # follow-on") instead of silently serving an unreplicated shard
        print("error: --repl-group requires the Python server (drop "
              "--native; native stored.cc replication is a named "
              "ROADMAP follow-on)", file=sys.stderr)
        return 2
    return _serve_shard_set(args, token, sslctx, watcher)


def _serve_shard_set(args, token, sslctx, watcher) -> int:
    """One supervising process, N shard servers on consecutive ports
    (N=1 is the ordinary single store on args.port with the plain FILE
    WAL name).  Each shard is an ordinary store server with its own WAL
    + snapshot sidecar (FILE.s<i>); the partitioning lives entirely in
    the clients' routing hash, so a shard set can equally be launched
    as N independent ``cronsun-store`` processes across machines (the
    production layout — docs/OPERATIONS.md)."""
    rc = [0]
    servers = []

    def shard_wal(i):
        if not args.wal:
            return None
        # N=1 keeps the plain FILE name (and its existing snapshot
        # sidecar from a pre-shard deployment)
        return args.wal if args.shards == 1 else f"{args.wal}.s{i}"

    def shard_port(i):
        # --port 0 = ephemeral: every shard picks its own free port
        # (0+i would try to bind fixed low ports); the READY line
        # carries the actual bound addresses either way
        return args.port + i if args.port else 0

    if args.native:
        from ..store.native import NativeStoreServer

        def child_died(code: int):
            # the wrapper must not sit healthy-looking in front of a dead
            # store — exit so process supervision restarts the set
            log.errorf("native store exited rc=%d; shutting down", code)
            rc[0] = code if code > 0 else 1   # signal deaths -> plain 1
            events.shutdown()
        for i in range(args.shards):
            srv = NativeStoreServer(host=args.host, port=shard_port(i),
                                    wal=shard_wal(i), token=token,
                                    stripes=args.stripes,
                                    compact_wal_bytes=args.compact_wal_bytes,
                                    snapshot_staggered=(
                                        args.snapshot_staggered == "on")
                                    ).start()
            srv.monitor(child_died)
            servers.append(srv)
    else:
        from ..store.memstore import MemStore
        for i in range(args.shards):
            kw0 = {"snapshot_staggered": args.snapshot_staggered == "on"}
            store = MemStore(stripes=args.stripes, **kw0) \
                if args.stripes > 0 else MemStore(**kw0)
            if args.wal:
                # replay (snapshot + tail) BEFORE serving: no concurrent
                # clients may observe a half-replayed keyspace
                kw = {}
                if args.compact_wal_bytes >= 0:   # 0 = disable, -1 = default
                    kw["compact_bytes"] = args.compact_wal_bytes
                store.open_wal(shard_wal(i), **kw)
            srv = StoreServer(store=store, host=args.host,
                              port=shard_port(i), token=token,
                              sslctx=sslctx)
            if args.repl_group:
                # attach the repl manager BEFORE serving so no client
                # op can race the follower-refusal / quorum wiring
                from ..repl import ReplManager
                members = [m.strip()
                           for m in args.repl_group.split("|")]
                self_addr = args.repl_self or f"{srv.host}:{srv.port}"
                srv.attach_repl(ReplManager(
                    store, self_addr, members, ack_mode=args.repl_ack,
                    token=token,
                    promote_after=args.repl_promote_after))
            srv.start()
            if srv.repl is not None:
                srv.repl.start()
            servers.append(srv)
    addrs = ",".join(f"{s.host}:{s.port}" for s in servers)
    if args.shards == 1:
        log.infof("cronsun-store serving on %s%s", addrs,
                  " (tls)" if sslctx is not None else "")
    else:
        log.infof("cronsun-store serving %d shards on %s%s", args.shards,
                  addrs, " (tls)" if sslctx is not None else "")
    print(f"READY {addrs}", flush=True)
    if args.health_port:
        from ..health import HealthServer, tcp_accept_check, \
            wal_writable_check
        checks = {"wal": wal_writable_check(args.wal)}
        for i, s in enumerate(servers):
            checks[f"shard{i}"] = tcp_accept_check(s.host, s.port)
        mgr = getattr(servers[0], "repl", None)
        if mgr is not None:
            # the standby pattern: a FOLLOWER fails exactly the
            # named 'leader' check (503 from /readyz keeps it out of
            # writer rotation) while shard/wal checks stay green
            checks["leader"] = lambda: (
                mgr.role() == "leader",
                f"role={mgr.role()} epoch={mgr.store.repl_epoch()}")
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
