"""Execution agent — one per machine (reference bin/node/server.go:23-70).

    python -m cronsun_tpu_torch.bin.node --store H:P [--node-id ID] [--conf F]

Copy of ``cronsun_tpu/bin/node.py``.
"""

from __future__ import annotations

import sys

from .. import events, log
from ..core.errors import DuplicateNode
from ..node.agent import NodeAgent
from .common import base_parser, connect_store, make_sink, setup_common


def main(argv=None) -> int:
    ap = base_parser(__doc__)
    ap.add_argument("--node-id", default=None,
                    help="stable node identity (default: local IP)")
    args = ap.parse_args(argv)
    cfg, ks, watcher = setup_common(args)

    store = connect_store(args.store, token=cfg.store_token, tls=cfg.store_tls,
                          prefix=cfg.prefix)
    sink = make_sink(cfg, args.logsink)
    fatal: list = []

    def on_fatal(e):
        fatal.append(e)
        events.shutdown()

    agent = NodeAgent(store, sink, node_id=args.node_id, ks=ks,
                      ttl=cfg.node_ttl, proc_ttl=cfg.proc_ttl,
                      lock_ttl=cfg.lock_ttl, proc_req=cfg.proc_req,
                      on_fatal=on_fatal,
                      trace_shift=cfg.trace_sample_shift)
    try:
        agent.start()
    except DuplicateNode as e:
        log.errorf("%s", e)
        return 1
    log.infof("cronsun-node %s up (store %s)", agent.id, args.store)
    print(f"READY {agent.id}", flush=True)

    def reload_conf(c):
        # dynamic knobs only — the reference reloads the proc lease the
        # same way (proc.go:37-52)
        agent.ttl = c.node_ttl
        agent.proc_ttl = c.proc_ttl
        agent.lock_ttl = c.lock_ttl
        agent.proc_req = c.proc_req
        log.infof("config reloaded")
    events.on(events.WAIT, reload_conf)
    events.on(events.EXIT, agent.stop, store.close)
    if watcher:
        events.on(events.EXIT, watcher.stop)
    events.wait()
    return 1 if fatal else 0


if __name__ == "__main__":
    sys.exit(main())
