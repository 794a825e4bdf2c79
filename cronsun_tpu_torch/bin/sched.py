"""Leader scheduler of the port — run one or more; they elect a leader.

    python -m cronsun_tpu_torch.bin.sched --store H:P [--conf F] [--device cuda|cpu]

The counterpart of ``cronsun_tpu/bin/sched.py``: the same flags, conf and
store wire, so it joins a fleet of the JAX package's (or the native)
store, agents and web processes, and takes over from a JAX leader
through the leader lease and a shared ``checkpoint_dir``.  It differs in:

- ``--device {cuda,cpu}`` (default ``cuda``) places the planner; with no
  card and no ``--device cpu`` startup fails, with no fallback.  A mesh
  planner's local shards go on ``cuda:0 .. L-1`` of this process's cards,
  or all on the CPU.
- ``--mesh-hosts N`` joins a ``torch.distributed`` gloo group at
  ``tcp://<--mesh-coordinator>`` (rank 0 hosts the rendezvous); D must
  divide over the N processes.
- on the card the kernels are built before ``READY``;
- ``--profile-port P`` serves torch.profiler captures over HTTP
  (``GET /capture?ms=N[&stack=1]``, a gzip Chrome trace; see
  ``cronsun_tpu_torch/profile_server.py``) where the reference starts
  ``jax.profiler.start_server``;
- on exit the process logs the kernels' launch counts.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

from .. import events, log
from ..device import resolve_device
from ..sched import SchedulerService
from .common import base_parser, connect_store, setup_common

# how long a collective of a multi-host mesh may wait: a worker waits in
# the next plan's broadcast for as long as its leader stands by
_MESH_TIMEOUT = datetime.timedelta(days=30)


def install_worker_signal_watchdog():
    """Mesh-worker signal policy: first SIGTERM/SIGINT is logged and
    ignored (the worker's normal stop is the leader's release broadcast;
    a rank dying mid-plan wedges the fleet's collectives), a second
    signal — or a single SIGUSR1 — force-exits.

    Escalation must work even while the main thread is parked inside a
    gloo collective that never returns to the interpreter — a pure Python
    signal handler only runs at bytecode boundaries, so it would never
    fire there.  Instead the C-level wakeup-fd path (written by CPython's
    signal trampoline in whichever thread receives the signal, regardless
    of what the main thread is doing) feeds a watchdog thread.
    SA_RESTART is restored so the first signal can't surface as EINTR
    mid-collective either.  Must be called from the main thread."""
    import signal as _signal
    import threading as _threading
    rfd, wfd = os.pipe()
    os.set_blocking(wfd, False)
    _signal.set_wakeup_fd(wfd, warn_on_full_buffer=False)
    for _sig in (_signal.SIGTERM, _signal.SIGINT, _signal.SIGUSR1):
        _signal.signal(_sig, lambda s, f: None)
        _signal.siginterrupt(_sig, False)
    _signal.pthread_sigmask(_signal.SIG_UNBLOCK,
                            {_signal.SIGTERM, _signal.SIGINT,
                             _signal.SIGUSR1})

    def _sig_watchdog():
        seen = 0
        while True:
            try:
                data = os.read(rfd, 64)
            except OSError:
                return
            for b in data:
                if b == _signal.SIGUSR1 or seen:
                    os.write(2, b"mesh worker: force exit\n")
                    os._exit(1)
                seen += 1
                os.write(2, b"mesh worker: first signal ignored "
                            b"(normal stop is the leader's release "
                            b"broadcast; signal again or SIGUSR1 to "
                            b"force exit)\n")
    _threading.Thread(target=_sig_watchdog, daemon=True,
                      name="sig-watchdog").start()


def _log_launch_counts():
    from ..ops import kernels
    log.infof("kernel launch counts: %s",
              json.dumps(kernels.launch_counts(), sort_keys=True))


def main(argv=None) -> int:
    ap = base_parser(__doc__)
    ap.add_argument("--node-id", default="scheduler-1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the planner runs (default: the CUDA card; "
                         "cpu runs the plain PyTorch path)")
    ap.add_argument("--profile-port", type=int, default=0, metavar="PORT",
                    help="serve live torch.profiler captures over HTTP "
                         "(GET /capture?ms=N[&stack=1] answers a gzip "
                         "Chrome trace of every thread) so tick/assign "
                         "spans can be captured live; 0 disables")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="shard the planner over a D-device jobs mesh "
                         "(0 = single device)")
    ap.add_argument("--mesh2d", default=None, metavar="DJxDN",
                    help="2-D (jobs x nodes) mesh instead of --mesh, "
                         "e.g. 4x2 — for fleets whose bitpacked "
                         "eligibility exceeds jobs-sharded memory")
    ap.add_argument("--mesh-hosts", type=int, default=1, metavar="N",
                    help="multi-host mesh: total participating processes "
                         "(torch.distributed; see --mesh-proc-id)")
    ap.add_argument("--mesh-proc-id", type=int, default=0, metavar="I",
                    help="this process's rank; 0 leads (store + dispatch), "
                         ">0 runs as a mesh worker joining the leader's "
                         "collective plans (no store connection)")
    ap.add_argument("--mesh-coordinator", default="127.0.0.1:8476",
                    metavar="H:P", help="torch.distributed rendezvous "
                                        "(rank 0's address)")
    ap.add_argument("--mesh-replicated-bids", action="store_true",
                    help="rollback switch: use the replicated-waterfill "
                         "reconcile (O(fired-bucket) exchange per round) "
                         "instead of bucket-sharded bidding (O(nodes)); "
                         "every rank of a multi-host mesh must agree")
    ap.add_argument("--mesh-demand-format", default="auto",
                    choices=("auto", "dense", "compacted"),
                    metavar="FMT",
                    help="demand wire format for the sharded reconcile: "
                         "auto picks dense vs compacted per plan from "
                         "the collective-bytes crossover; dense/"
                         "compacted pin it; every rank of a multi-host "
                         "mesh must agree")
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
    if args.mesh2d is not None:
        try:
            dj, dn = (int(x) for x in args.mesh2d.lower().split("x"))
        except ValueError:
            dj = dn = 0
        if dj < 1 or dn < 1:
            print("error: --mesh2d wants DJxDN with both >= 1 (e.g. 4x2)",
                  file=sys.stderr)
            return 2
        if args.mesh:
            print("error: --mesh and --mesh2d are mutually exclusive",
                  file=sys.stderr)
            return 2
        args.mesh = dj * dn
    if args.mesh_hosts > 1:
        # flag errors must surface BEFORE the rendezvous: it blocks
        # waiting for every rank, and a rank that errors out after
        # connecting would leave the others wedged in the first collective
        if args.mesh < 2:
            print("error: --mesh-hosts requires --mesh D or --mesh2d "
                  "DJxDN (global device count)", file=sys.stderr)
            return 2
        if args.mesh % args.mesh_hosts:
            print(f"error: {args.mesh} mesh devices do not divide over "
                  f"--mesh-hosts {args.mesh_hosts}", file=sys.stderr)
            return 2
        if not 0 <= args.mesh_proc_id < args.mesh_hosts:
            print(f"error: --mesh-proc-id {args.mesh_proc_id} out of range "
                  f"for --mesh-hosts {args.mesh_hosts}", file=sys.stderr)
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
    profiler = None
    if args.profile_port:
        # before the rendezvous: a rank that fails after it wedges the rest
        from ..profile_server import ProfileServer
        try:
            profiler = ProfileServer(args.profile_port, device)
        except OSError as e:
            print(f"error: --profile-port {args.profile_port}: "
                  f"{e.strerror or e}", file=sys.stderr)
            return 1
        log.infof("torch profiler server on :%d", args.profile_port)
    if args.mesh_hosts > 1:
        # the global mesh assembles every process's local shards; its
        # collectives run over gloo on host tensors
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.mesh_coordinator}",
            world_size=args.mesh_hosts, rank=args.mesh_proc_id,
            timeout=_MESH_TIMEOUT)

    tz = None
    if cfg.timezone and cfg.timezone.upper() != "UTC":
        from zoneinfo import ZoneInfo
        tz = ZoneInfo(cfg.timezone)
    planner = None
    shard_bids = not args.mesh_replicated_bids
    if args.mesh2d is not None:
        from ..parallel.mesh import Sharded2DTickPlanner, make_mesh2d
        planner = Sharded2DTickPlanner(
            make_mesh2d(dj, dn, device), job_capacity=cfg.job_capacity,
            node_capacity=cfg.node_capacity, tz=tz, shard_bids=shard_bids,
            demand_format=args.mesh_demand_format)
        log.infof("planner sharded over a %dx%d (jobs x nodes) mesh "
                  "(%s bidding, %s demand)", dj, dn,
                  "bucket-sharded" if shard_bids else "replicated",
                  args.mesh_demand_format)
    elif args.mesh > 1:
        from ..parallel.mesh import ShardedTickPlanner, make_mesh
        planner = ShardedTickPlanner(
            make_mesh(args.mesh, device), job_capacity=cfg.job_capacity,
            node_capacity=cfg.node_capacity, tz=tz, shard_bids=shard_bids,
            demand_format=args.mesh_demand_format)
        log.infof("planner sharded over %d devices (%s bidding, "
                  "%s demand)", args.mesh,
                  "bucket-sharded" if shard_bids else "replicated",
                  args.mesh_demand_format)
    if args.mesh_hosts > 1 and args.mesh_proc_id > 0:
        # mesh worker: no store, no leadership — replay the leader's
        # broadcast deltas and join its collective plans until told to
        # stop (parallel/hostsync.py documents the protocol).  Signal
        # policy: see install_worker_signal_watchdog.
        install_worker_signal_watchdog()
        from ..parallel.hostsync import run_worker
        log.infof("mesh worker %d/%d up (coordinator %s)",
                  args.mesh_proc_id, args.mesh_hosts,
                  args.mesh_coordinator)
        print(f"READY mesh-worker-{args.mesh_proc_id}", flush=True)
        steps = run_worker(planner)
        log.infof("mesh worker released after %d plan steps", steps)
        _log_launch_counts()
        if profiler is not None:
            profiler.stop()
        # join gloo's threads now: left to interpreter teardown, the
        # process group's destructor can abort the exit ("terminate
        # called without an active exception", exit -6)
        dist.destroy_process_group()
        return 0
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
    sync_proxy = None
    if args.mesh_hosts > 1:
        from ..parallel.hostsync import PlannerSyncProxy
        planner = sync_proxy = PlannerSyncProxy(planner)
        log.infof("mesh leader: broadcasting plan deltas to %d workers",
                  args.mesh_hosts - 1)
    # single-process mesh planners checkpoint like the plain one (shards
    # assembled on the host, topology-tagged); proxied multi-host planners
    # are refused by SchedulerService itself (it logs why)
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
        dispatch_ttl=cfg.lock_ttl, tz=tz, planner=planner,
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
    if sync_proxy is not None:
        # stop order matters: join the service loop FIRST so no plan
        # broadcast can interleave with the workers' release
        events.on(events.EXIT, sched.stop, sync_proxy.shutdown_workers,
                  _log_launch_counts, store.close)
    else:
        events.on(events.EXIT, sched.stop, _log_launch_counts, store.close)
    if profiler is not None:
        events.on(events.EXIT, profiler.stop)
    if health is not None:
        events.on(events.EXIT, health.stop)
    if watcher:
        events.on(events.EXIT, watcher.stop)
    events.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
