"""Single-process demo: store + scheduler + agents + API + noticer.

    python -m cronsun_tpu_torch.demo [--nodes N] [--port P] [--conf file.json]
                                     [--device cuda|cpu]

Brings the whole system up in one process (the in-memory store plays etcd),
seeds a couple of example jobs, and serves the management UI at
http://127.0.0.1:<port>/ui/ (login admin@admin.com / admin).

Copy of ``cronsun_tpu/demo.py``.  The scheduler plans on the card
(``--device``, default ``cuda``; with no card and no ``--device cpu`` the
demo exits 1 at startup, with no fallback), its table at the conf's
``job_capacity`` x ``node_capacity``.  SIGTERM shuts down as Ctrl-C does:
the summary line, exit 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

from .conf import parse as parse_conf
from .core import Job, JobRule, Keyspace, KIND_ALONE, KIND_COMMON
from .device import resolve_device
from .logsink import JobLogStore
from .node.agent import NodeAgent
from .noticer import Notice, NoticerHost
from .sched import SchedulerService
from .store import MemStore
from .web import ApiServer


class PrintSender:
    def send(self, notice: Notice):
        print(f"[notice] {notice.subject}: {notice.body}", flush=True)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--port", type=int, default=7079)
    ap.add_argument("--conf", default=None)
    ap.add_argument("--seconds", type=float, default=0,
                    help="run for N seconds then exit (0 = forever)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the scheduler plans (default: the card; "
                         "no fallback)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        from .ops import _build
        _build.build()      # nvcc before the first window, not inside it
    else:
        # the plain planner issues many small ops; a pool of intra-op
        # threads per op, against this process's agents and web and any
        # other load on the host, made whole windows run seconds late
        import torch
        torch.set_num_threads(1)

    cfg = parse_conf(args.conf)
    ks = Keyspace(cfg.prefix)
    store = MemStore()
    store.start_sweeper()
    sink = JobLogStore()  # in-memory for the demo

    agents = [NodeAgent(store, sink, node_id=f"node-{i}", ks=ks,
                        ttl=cfg.node_ttl, proc_ttl=cfg.proc_ttl,
                        lock_ttl=cfg.lock_ttl)
              for i in range(args.nodes)]
    for a in agents:
        a.start()

    sched = SchedulerService(store, ks=ks, job_capacity=cfg.job_capacity,
                             node_capacity=cfg.node_capacity,
                             window_s=cfg.window_s,
                             default_node_cap=cfg.default_node_cap,
                             device=device)
    sched.start()

    api = ApiServer(store, sink, ks=ks, security=cfg.security,
                    host="127.0.0.1", port=args.port).start()
    noticer = NoticerHost(store, sink, PrintSender(), ks=ks)
    noticer.start()

    node_ids = [a.id for a in agents]
    for name, cmd, kind in (
            ("heartbeat", "echo beat", KIND_COMMON),
            ("singleton-date", "date", KIND_ALONE)):
        job = Job(name=name, command=cmd, kind=kind, fail_notify=True,
                  rules=[JobRule(timer="*/5 * * * * *", nids=node_ids)])
        job.check()
        store.put(ks.job_key(job.group, job.id), job.to_json())

    print(f"cronsun-tpu demo up: {args.nodes} agents, scheduler leader="
          f"{sched.is_leader}, UI http://127.0.0.1:{api.port}/ui/ "
          f"(admin@admin.com / admin)", flush=True)
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        if args.seconds:
            time.sleep(args.seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        print("shutting down...", flush=True)
        noticer.stop()
        api.stop()
        sched.stop()
        for a in agents:
            a.stop()
        store.close()
        logs, total = sink.query_logs()
        print(f"executed {total} runs across "
              f"{len({l.node for l in logs})} nodes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
