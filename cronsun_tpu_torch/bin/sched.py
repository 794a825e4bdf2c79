"""Leader scheduler of the port — run one or more; they elect a leader.

    python -m cronsun_tpu_torch.bin.sched --store H:P [--conf F] [--device cuda|cpu]

The counterpart of ``cronsun_tpu/bin/sched.py``: the same flags, conf and
store wire, so it joins a fleet of the JAX package's (or the native)
store, agents and web processes, and takes over from a JAX leader
through the leader lease and a shared ``checkpoint_dir``.  It differs in:

- ``--device {cuda,cpu}`` (default ``cuda``) places the planner; with no
  card and no ``--device cpu`` startup fails, with no fallback.
- on the card the kernels are built before ``READY``;
- ``--profile-port`` exits 2 (the port has no profiler server), and so
  does any mesh flag other than its single-device default (the mesh
  planners are not ported yet);
- on exit the process logs both kernels' launch counts.
"""

from __future__ import annotations

import json
import os
import sys

from .. import events, log
from ..device import resolve_device
from ..sched import SchedulerService
from .common import base_parser, connect_store, setup_common

_MESH_COORDINATOR = "127.0.0.1:8476"


def _mesh_flags_set(args) -> list:
    """The mesh flags given a value other than their single-device
    default."""
    return [flag for flag, on in (
        ("--mesh", args.mesh != 0), ("--mesh2d", args.mesh2d is not None),
        ("--mesh-hosts", args.mesh_hosts != 1),
        ("--mesh-proc-id", args.mesh_proc_id != 0),
        ("--mesh-coordinator", args.mesh_coordinator != _MESH_COORDINATOR),
        ("--mesh-replicated-bids", args.mesh_replicated_bids),
        ("--mesh-demand-format", args.mesh_demand_format != "auto")) if on]


def main(argv=None) -> int:
    ap = base_parser(__doc__)
    ap.add_argument("--node-id", default="scheduler-1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the planner runs (default: the CUDA card; "
                         "cpu runs the plain PyTorch path)")
    ap.add_argument("--profile-port", type=int, default=0, metavar="PORT",
                    help="refused: the port has no profiler server")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="refused unless 0: mesh planners are not ported")
    ap.add_argument("--mesh2d", default=None, metavar="DJxDN",
                    help="refused: mesh planners are not ported")
    ap.add_argument("--mesh-hosts", type=int, default=1, metavar="N",
                    help="refused unless 1: mesh planners are not ported")
    ap.add_argument("--mesh-proc-id", type=int, default=0, metavar="I",
                    help="refused unless 0: mesh planners are not ported")
    ap.add_argument("--mesh-coordinator", default=_MESH_COORDINATOR,
                    metavar="H:P", help="refused unless the default: mesh "
                                        "planners are not ported")
    ap.add_argument("--mesh-replicated-bids", action="store_true",
                    help="refused: mesh planners are not ported")
    ap.add_argument("--mesh-demand-format", default="auto",
                    choices=("auto", "dense", "compacted"),
                    metavar="FMT",
                    help="refused unless auto: mesh planners are not ported")
    ap.add_argument("--health-port", type=int, default=0, metavar="P",
                    help="serve /healthz + /readyz on this port "
                         "(readiness: leader lease / watches / step "
                         "loop; 0 disables)")
    ap.add_argument("--partitions", type=int, default=1, metavar="P",
                    help="partitioned scheduler plane: total number of "
                         "job-space partitions (the fleet runs one "
                         "leader, plus standbys, per partition; the "
                         "first leader pins sched/partmap and "
                         "mismatched counts refuse to start; default "
                         "1 = the unpartitioned scheduler)")
    ap.add_argument("--partition", type=int, default=0, metavar="I",
                    help="this scheduler's partition index in "
                         "[0, --partitions)")
    args = ap.parse_args(argv)
    if args.partitions < 1 or not 0 <= args.partition < args.partitions:
        print(f"error: --partition {args.partition} out of range for "
              f"--partitions {args.partitions}", file=sys.stderr)
        return 2
    if args.partitions > 1 and args.node_id == "scheduler-1":
        # the default node id must not collide across partition
        # processes OR between a partition's leader and its warm
        # standbys launched with the same flags (it keys the leased
        # metrics snapshot — a collision makes the fleet view flap);
        # the pid disambiguates, operators wanting stable instance
        # labels set explicit --node-id
        args.node_id = f"scheduler-p{args.partition}-{os.getpid()}"
    if args.profile_port:
        print("error: --profile-port: the torch port has no profiler "
              "server", file=sys.stderr)
        return 2
    mesh = _mesh_flags_set(args)
    if mesh:
        print(f"error: {', '.join(mesh)}: mesh planners are not ported yet "
              "(run one single-device scheduler per partition)",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 1
    cfg, ks, watcher = setup_common(args)
    if device.type == "cuda":
        # a fresh host's first leader window would otherwise pay nvcc
        # inside the step loop
        from ..ops import _build
        log.infof("kernels built in %.2f s on %s", _build.build(), device)

    tz = None
    if cfg.timezone and cfg.timezone.upper() != "UTC":
        from zoneinfo import ZoneInfo
        tz = ZoneInfo(cfg.timezone)
    store = connect_store(args.store, token=cfg.store_token, tls=cfg.store_tls,
                          prefix=cfg.prefix)
    if args.partitions > 1:
        # a duplicate --node-id across partition processes silently
        # corrupts the fleet view (the leased metrics snapshot is
        # keyed by instance — one partition's numbers overwrite the
        # other's, readyz pages a healthy partition as leaderless):
        # scheduling itself stays correct, so warn LOUDLY rather than
        # refuse (the colliding snapshot may be our own previous
        # incarnation's unexpired lease)
        try:
            kv = store.get(ks.metrics_key("sched", args.node_id))
            other = (json.loads(kv.value).get("partition")
                     if kv is not None else None)
        except Exception:  # noqa: BLE001 — advisory check only
            other = None
        if other is not None and int(other) != args.partition:
            log.errorf(
                "node-id %r already publishes sched metrics as "
                "partition %s — duplicate --node-id across partitions "
                "corrupts /v1/sched and readyz; give each partition "
                "process a distinct --node-id", args.node_id, other)
    ckpt_dir = os.path.expanduser(cfg.checkpoint_dir) \
        if cfg.checkpoint_dir else None
    if ckpt_dir and args.partitions > 1:
        # per-partition checkpoint chains: each partition's built state
        # is its own restore point (a foreign partition's checkpoint is
        # refused by the restore's slice validation anyway)
        ckpt_dir = os.path.join(ckpt_dir, f"p{args.partition}")
        os.makedirs(ckpt_dir, exist_ok=True)
    sched = SchedulerService(
        store, ks=ks, job_capacity=cfg.job_capacity,
        node_capacity=cfg.node_capacity, window_s=cfg.window_s,
        default_node_cap=cfg.default_node_cap, node_id=args.node_id,
        dispatch_ttl=cfg.lock_ttl, tz=tz,
        pipelined=None if cfg.pipelined_step else False,
        checkpoint_dir=ckpt_dir,
        checkpoint_interval_s=float(cfg.checkpoint_interval),
        checkpoint_delta=cfg.checkpoint_delta,
        delta_max_chain=cfg.checkpoint_rebase_chain,
        delta_max_bytes=cfg.checkpoint_rebase_bytes,
        trace_shift=cfg.trace_sample_shift,
        partitions=args.partitions, partition=args.partition,
        device=device)
    sched.start()
    health = None
    if args.health_port:
        from ..health import HealthServer

        def leader_check():
            h = sched.health()
            return h["leader"], json.dumps(h)

        def watches_check():
            h = sched.health()
            return h["watches_open"] > 0 and h["loop_alive"], \
                json.dumps(h)
        health = HealthServer(
            {"leader": leader_check, "watches": watches_check},
            port=args.health_port).start()
    if args.partitions > 1:
        log.infof("cronsun-sched %s up (store %s, tz %s, partition "
                  "%d/%d, device %s)", args.node_id, args.store,
                  cfg.timezone, args.partition, args.partitions, device)
    else:
        log.infof("cronsun-sched %s up (store %s, tz %s, device %s)",
                  args.node_id, args.store, cfg.timezone, device)
    print(f"READY {args.node_id}", flush=True)

    def log_launch_counts():
        from ..ops import kernels
        log.infof("kernel launch counts: %s",
                  json.dumps(kernels.launch_counts(), sort_keys=True))

    events.on(events.EXIT, sched.stop, log_launch_counts, store.close)
    if health is not None:
        events.on(events.EXIT, health.stop)
    if watcher:
        events.on(events.EXIT, watcher.stop)
    events.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
