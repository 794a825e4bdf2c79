"""Shared entrypoint wiring: flags, conf, logging, store connection.

Copy of ``cronsun_tpu/bin/common.py`` without ``enable_compile_cache``
(an XLA cache; the port builds its kernels with ``ops._build``).
``server_tls`` serves the store and result-store processes, ``make_sink``
the agent and web processes.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

from .. import events, log
from ..conf import Config, ConfigWatcher, parse as parse_conf
from ..core import Keyspace


def base_parser(doc: str, store_required: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--conf", default=None, help="JSON config file")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warn", "error"))
    if store_required:
        ap.add_argument("--store", default="127.0.0.1:7070",
                        metavar="HOST:PORT",
                        help="coordination store address")
        ap.add_argument("--logsink", default=None, metavar="HOST:PORT",
                        help="networked result store (cronsun-logd) "
                             "address, or a comma-joined SHARD SET "
                             "(h1:7078,h2:7078,...) routed by the "
                             "deterministic job hash; default: conf "
                             "log_addr, else the local log_db SQLite "
                             "file")
    return ap


def setup_common(args) -> Tuple[Config, Keyspace, Optional[ConfigWatcher]]:
    """Logging + conf + hot-reload watcher (reload emits events.WAIT, the
    reference's fsnotify->WAIT wiring, conf/conf.go:159-193)."""
    log.setup(args.log_level)
    cfg = parse_conf(args.conf)
    watcher = None
    if args.conf:
        watcher = ConfigWatcher(
            args.conf, cfg, lambda c: events.emit(events.WAIT, c))
        watcher.start()
    return cfg, Keyspace(cfg.prefix), watcher


def server_tls(tls, native: bool, daemon: str):
    """Server-side TLS context from a conf section, or None (plaintext).
    The native servers cannot terminate TLS — exits 2 with the
    terminator hint rather than silently serving plaintext."""
    import sys
    from ..tlsutil import server_context
    ctx = server_context(tls)
    if ctx is not None and native:
        print(f"error: {daemon} TLS requires the Python server (drop "
              "--native or terminate TLS in front of the native daemon "
              "-- native/README.md)", file=sys.stderr)
        raise SystemExit(2)
    return ctx


def connect_store(addr: str, token: str = "", tls=None,
                  timeout: float = 120.0, prefix: str = "/cronsun"):
    """``tls`` is the conf ``store_tls`` section (tlsutil.Tls) or None.

    ``addr`` may be a comma-separated SHARD SET ("h1:7070,h2:7070,…"):
    more than one address returns a routing ShardedStore (same client
    surface, keyspace partitioned by the deterministic token hash —
    store/sharded.py); one address returns the plain RemoteStore after
    the read-only shard-map pin check (a stale single-store config
    pointed at one shard of a sharded layout refuses at startup).

    Each shard entry may itself be an ``a1|a2|a3`` REPLICA GROUP
    (replication plane, repl/): the shard routes to the group's
    leader and rotates on failover.  Empty members ("a|,b", "a||b")
    refuse at parse time with the malformed group named.

    The default RPC timeout is generous because bulk operations scale
    with fleet size: a scheduler cold-loading 1M jobs lists the whole
    cmd prefix in one call (hundreds of MB of JSON — measured over 10 s
    on a 1-core store host, which timed out the old 10 s default
    mid-boot)."""
    from ..tlsutil import client_context
    sslctx = client_context(tls) if tls is not None else None
    addrs = [a.strip() for a in addr.split(",") if a.strip()]
    if not addrs:
        raise ValueError(
            f"store address {addr!r} has no host:port entries")
    from ..store.sharded import connect_sharded
    return connect_sharded(addrs, prefix=prefix, timeout=timeout,
                           token=token, sslctx=sslctx,
                           tls_hostname=tls.hostname if tls else "")


def make_sink(cfg: Config, log_addr: Optional[str] = None):
    """Result-store handle: the networked store when an address is
    configured (processes may live on different machines — the
    reference's Mongo topology), else the local SQLite file.

    ``log_addr`` may be a comma-joined SHARD SET ("h1:7078,h2:7078,…"):
    more than one address returns a routing ShardedJobLogStore (same
    client surface, record space partitioned by the deterministic
    job-id hash — logsink/sharded.py); one address returns the plain
    RemoteJobLogStore after the read-only logmap pin check (a stale
    single-sink config pointed at one shard of a sharded layout
    refuses at startup)."""
    addr = log_addr if log_addr is not None else cfg.log_addr
    if addr:
        from ..logsink.sharded import connect_sharded_sink
        from ..tlsutil import client_context
        return connect_sharded_sink(
            [a.strip() for a in addr.split(",") if a.strip()],
            token=cfg.log_token, sslctx=client_context(cfg.log_tls),
            tls_hostname=cfg.log_tls.hostname)
    from ..logsink import JobLogStore
    return JobLogStore(cfg.log_db)
