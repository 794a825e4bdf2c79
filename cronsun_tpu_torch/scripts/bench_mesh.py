"""Mesh latency ladder of the PyTorch port: tick+assign over the 1-D and 2-D
meshes, bucket-sharded against replicated reconcile, across shard counts
(the counterpart of ``scripts/bench_mesh.py``).

- tick p50/p99 per (shard count, mesh kind, reconcile path), synchronous
  per tick and the fused windowed cadence;
- per-phase times (bid, collective exchange, reconcile) from the planner's
  ``profile_phases`` at the same shapes;
- the collective payload bytes of both reconcile paths from the byte model
  (``estimate_collective_bytes``) beside the bytes the collectives moved
  (``measured_collective_bytes``), and the fire-set divergence of the two
  demand formats.

A rung is a mesh over a list of torch devices, built in this process (one
process drives all its shards).  On the card, a rung with more shards than
there are cards puts several shards on one card (``shards_per_device`` in
its record): with one card the ladder measures the mesh's host cost, not a
multi-card speed-up.  ``--device cpu`` puts every shard on the CPU.

``--mesh-hosts N --mesh-proc-id R --mesh-coordinator H:P``, run once per
process, adds the multi-process rungs (the JAX script's DCN rungs): the
sparse rungs again over one mesh whose shards divide over the N processes,
joined by ``torch.distributed`` over gloo.  Every process prints; rank 0's
output is the run's.

    python -m cronsun_tpu_torch.scripts.bench_mesh [--devices 1,2,4,8]
        [--shapes JxN,...] [--ticks T] [--quick] [--sparse]
        [--device cpu] [--out MULTICHIP_ladder.json]

Flags and record keys are the JAX script's, plus ``--device``, the
multi-process flags and ``shards_per_device``.  A rung that raises fails
the run.  Prints one JSON object on stdout.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def git_rev() -> str:
    """Short HEAD of the checkout, "unknown" outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=ROOT)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# ---------------------------------------------------------------------------
# one rung
# ---------------------------------------------------------------------------

def _pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def rung_mesh(cfg: dict, device=None):
    """(mesh, shards per device) of a rung: ``cfg["devices"]`` shards, a
    ``(dj, dn)`` grid for ``cfg["mesh"] == "2d"``.  A ``dcn`` rung divides
    the shards over the initialized ``torch.distributed`` processes, any
    other rung is this process's alone.  On the card shard i of a process
    takes card i mod the card count."""
    import torch

    from ..parallel.mesh import AXIS, NAXIS, Mesh
    dev = resolve_device(device)
    world, rank = 1, 0
    if cfg.get("dcn"):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("a dcn rung needs torch.distributed "
                               "initialized (--mesh-hosts)")
        world, rank = dist.get_world_size(), dist.get_rank()
    D = cfg["devices"]
    if D % world:
        raise ValueError(f"{D} shards do not divide over {world} processes")
    n_local = D // world
    if dev.type == "cpu":
        devs = [dev] * D
        per = n_local
    else:
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", (g % n_local) % count)
                for g in range(D)]
        per = -(-n_local // count)
    grid = np.empty(D, dtype=object)
    grid[:] = devs
    if cfg["mesh"] == "2d":
        return Mesh(grid.reshape(cfg["dj"], cfg["dn"]), (AXIS, NAXIS),
                    world, rank), per
    return Mesh(grid, (AXIS,), world, rank), per


def run_worker(cfg: dict, device=None) -> dict:
    """One rung (``scripts/bench_mesh.py``'s worker config): plan
    ``ticks`` timed ticks after two warm ones, then the windowed cadence,
    the byte model against the bytes moved, the demand-format divergence
    (``check_divergence``) and the phase microbench.  Returns the record."""
    from ..parallel.mesh import Sharded2DTickPlanner, ShardedTickPlanner
    from ..synth import synth_table

    dev = resolve_device(device)
    mesh, per_device = rung_mesh(cfg, dev)
    J, N = cfg["J"], cfg["N"]
    bucket = cfg["bucket"]
    fmtarg = cfg.get("demand_format", "auto")

    def mk(fmt_):
        if cfg["mesh"] == "2d":
            p = Sharded2DTickPlanner(
                mesh, job_capacity=J, node_capacity=N,
                max_fire_bucket=bucket,
                shard_bids=cfg["path"] == "sharded", demand_format=fmt_)
        else:
            p = ShardedTickPlanner(
                mesh, job_capacity=J, node_capacity=N,
                max_fire_bucket=bucket, impl="jnp",
                shard_bids=cfg["path"] == "sharded", demand_format=fmt_)
        rng = np.random.default_rng(0)
        # fire-rate sized so a healthy slice of the bucket fires every
        # tick (the reconcile paths differ exactly in how fired-bucket
        # bytes scale, so an idle table would measure nothing); sparse
        # rungs pin every period to 1/fire_fraction
        p.set_table(synth_table(p.J, cfg["period_lo"], cfg["period_hi"],
                                device="cpu"))
        p.set_eligibility(rng.integers(
            0, 2**32, (p.J, p.N // 32), dtype=np.uint32))
        p.set_job_meta_full(rng.random(p.J) < 0.5,
                            np.ones(p.J, np.float32))
        p.set_node_capacity_full(np.full(p.N, 1 << 20, np.int32))
        return p

    sp = mk(fmtarg)
    T0 = 1_753_000_000
    sp.plan(T0 - 10)                      # warm
    sp.plan(T0 - 9)
    sp.tick_ms.clear()
    lat = []
    for i in range(cfg["ticks"]):
        s = time.perf_counter()
        p = sp.plan(T0 + i)
        lat.append((time.perf_counter() - s) * 1e3)
    fired = len(p.fired)

    W = cfg["window"]
    win_ms = 0.0
    if W > 1:
        sp.plan_window(T0 + 1000, W)      # warm
        s = time.perf_counter()
        for r in range(cfg["win_reps"]):
            sp.plan_window(T0 + 2000 + r * W, W)
        win_ms = (time.perf_counter() - s) * 1e3 / (cfg["win_reps"] * W)

    est = sp.estimate_collective_bytes(bucket)
    fmt = est["demand_format"]
    # the byte model next to what the collectives moved per tick in the
    # last plan (same bucket, same format)
    measured = sp.measured_collective_bytes()

    # fire-set divergence vs the OTHER demand format on the same seed
    # and tick sequence
    divergence = None
    if cfg.get("check_divergence") and cfg["path"] == "sharded":
        alt = "dense" if fmt == "compacted" else "compacted"
        divergence = 0
        # replay both planners fresh so carried load/rem_cap histories
        # match tick for tick
        sa, sb = mk(fmt), mk(alt)
        for t in [T0 - 10, T0 - 9] + [T0 + i for i in range(cfg["ticks"])]:
            pa, pb = sa.plan(t), sb.plan(t)
            if (sorted(pa.fired.tolist()) != sorted(pb.fired.tolist())
                    or dict(zip(pa.fired.tolist(), pa.assigned.tolist()))
                    != dict(zip(pb.fired.tolist(), pb.assigned.tolist()))):
                divergence += 1

    prof = sp.profile_phases(bucket, iters=3 if cfg["quick"] else 8)
    rec = {
        "devices": cfg["devices"], "mesh": cfg["mesh"], "path": cfg["path"],
        "jobs": sp.J, "nodes": sp.N, "k_local": est["k_local"],
        "ticks": cfg["ticks"], "fired_per_tick": fired,
        "tick_p50_ms": round(_pctl(lat, 0.50), 3),
        "tick_p99_ms": round(_pctl(lat, 0.99), 3),
        "windowed_ms_per_tick": round(win_ms, 3),
        "collective_bytes_per_round": est["per_round"],
        "collective_bytes_per_tick": est["per_tick"],
        "replicated_bytes_per_round": est["replicated_per_round"],
        "sharded_bytes_per_round": est["sharded_per_round"],
        "compacted_bytes_per_round": est["compacted_per_round"],
        "demand_format": fmt,
        "demand_format_requested": fmtarg,
        "predicted_bytes_per_tick": est["per_tick"],
        "measured_bytes_per_tick": measured,
        "shards_per_device": per_device,
        **{f"phase_{k}": v for k, v in prof.items()},
    }
    if cfg.get("fire_fraction") is not None:
        rec["fire_fraction"] = cfg["fire_fraction"]
    if divergence is not None:
        rec["fire_set_divergence"] = divergence
    if cfg.get("dcn"):
        rec["dcn_processes"] = mesh.process_count
    return rec


# ---------------------------------------------------------------------------
# the ladders
# ---------------------------------------------------------------------------

def run_ladder(devices, shapes, ticks, quick, on_log=log,
               demand_format="auto", device=None):
    ladder = []
    for J, N in shapes:
        for D in devices:
            kinds = [("1d", D, 1)]
            if D >= 4 and D % 2 == 0:
                kinds.append(("2d", D // 2, 2))
            for mesh, dj, dn in kinds:
                per = {}
                for path in ("sharded", "replicated"):
                    cfg = dict(
                        devices=D, mesh=mesh, dj=dj, dn=dn, J=J, N=N,
                        path=path,
                        # 2x headroom over the ~J/8 mean fire rate
                        # below, so bursty ticks don't clip the bucket
                        # (a clipped bucket caps the very traffic term
                        # being measured)
                        bucket=max(2048, J // 4), ticks=ticks,
                        window=1 if quick else 4,
                        win_reps=2, quick=quick,
                        demand_format=demand_format,
                        check_divergence=quick,
                        # ~8-25% of jobs fire per tick: enough candidate
                        # pressure that the bucket is the traffic term
                        period_lo=4, period_hi=12)
                    r = run_worker(cfg, device)
                    ladder.append(r)
                    per[path] = r
                    on_log(f"{D}dev {mesh} {J}x{N} {path}: "
                           f"p50={r['tick_p50_ms']}ms "
                           f"p99={r['tick_p99_ms']}ms "
                           f"bytes/round={r['collective_bytes_per_round']}"
                           f" fired={r['fired_per_tick']}")
                s, rpl = per["sharded"], per["replicated"]
                ladder.append({
                    "devices": D, "mesh": mesh, "jobs": s["jobs"],
                    "nodes": s["nodes"], "path": "compare",
                    "bytes_ratio": round(
                        s["collective_bytes_per_round"]
                        / max(1, rpl["collective_bytes_per_round"]), 4),
                    "p99_ratio": round(
                        s["tick_p99_ms"] / max(1e-9, rpl["tick_p99_ms"]),
                        4),
                })
    return ladder


# sparse-tick rungs: the corner the compacted demand gather targets —
# few fires on wide fleets, where the dense [2, N] exchange pays O(N)
# bytes for O(fired) demand.  fire fraction f is realized through the
# synth table's @every period (uniform phases -> ~J*f candidates/tick)
SPARSE_FRACTIONS = (0.001, 0.01, 0.1)
SPARSE_WIDTHS = (10_000, 100_000)


def run_sparse_ladder(devices, quick, on_log=log, demand_format="auto",
                      dcn=False, device=None):
    D = max(devices)
    J = 16_384 if quick else 65_536
    rungs = []
    for N in SPARSE_WIDTHS:
        for f in SPARSE_FRACTIONS:
            period = max(1, round(1 / f))
            cfg = dict(
                devices=D, mesh="1d", dj=D, dn=1, J=J, N=N,
                path="sharded", fire_fraction=f,
                # 4x headroom over the ~J*f mean so bursty ticks don't
                # clip the very bucket term being measured
                bucket=max(2048, int(4 * J * f)),
                ticks=3 if quick else 10, window=1, win_reps=1,
                quick=quick, dcn=dcn,
                demand_format=demand_format,
                check_divergence=True,
                # periods are drawn from [lo, hi): one period, 1/f
                period_lo=period, period_hi=period + 1)
            r = run_worker(cfg, device)
            rungs.append(r)
            on_log(f"sparse {D}dev {J}x{N} f={f}: fmt={r['demand_format']}"
                   f" bytes/round={r['collective_bytes_per_round']}"
                   f" (dense={r['sharded_bytes_per_round']}"
                   f" comp={r['compacted_bytes_per_round']})"
                   f" predicted={r['predicted_bytes_per_tick']}"
                   f" measured={r['measured_bytes_per_tick']}"
                   f" divergence={r.get('fire_set_divergence')}")
    return rungs


def init_hosts(hosts: int, proc_id: int, coordinator: str) -> None:
    """Join the ``hosts``-process group (gloo) at ``coordinator``."""
    import torch.distributed as dist
    if not 0 <= proc_id < hosts:
        raise ValueError(f"--mesh-proc-id {proc_id} not in [0, {hosts})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=hosts, rank=proc_id)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--worker", metavar="JSON", default=None,
                    help="run one rung config and print its record")
    ap.add_argument("--devices", default="1,2,4,8",
                    help="shard-count ladder")
    ap.add_argument("--shapes", default="65536x1024",
                    help="JxN job/node shapes, comma-joined")
    ap.add_argument("--ticks", type=int, default=20,
                    help="timed sync ticks per config")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: 2 shards, small shape, few ticks")
    ap.add_argument("--mesh-demand-format", default="auto",
                    choices=("auto", "dense", "compacted"),
                    help="pin the sharded reconcile's demand wire format "
                         "(auto = per-plan crossover pick)")
    ap.add_argument("--sparse", action="store_true",
                    help="also run the sparse-tick rungs (fire fractions "
                         f"{SPARSE_FRACTIONS} x widths {SPARSE_WIDTHS}; "
                         "always on in full mode)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write a MULTICHIP-sidecar-format JSON")
    ap.add_argument("--device", default=None,
                    help="torch device of the shards (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--mesh-hosts", type=int, default=1,
                    help="processes of the multi-process rungs (gloo)")
    ap.add_argument("--mesh-proc-id", type=int, default=0)
    ap.add_argument("--mesh-coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous of the multi-process rungs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh_hosts > 1 and not args.mesh_coordinator:
        ap.error("--mesh-hosts needs --mesh-coordinator")

    if args.worker is not None:
        cfg = json.loads(args.worker)
        if cfg.get("dcn"):
            init_hosts(args.mesh_hosts, args.mesh_proc_id,
                       args.mesh_coordinator)
        print(json.dumps(run_worker(cfg, dev)))
        return 0

    if args.quick:
        devices = [2]
        shapes = [(4096, 128)]
        ticks = 5
    else:
        devices = [int(x) for x in args.devices.split(",") if x]
        shapes = [tuple(int(v) for v in s.lower().split("x"))
                  for s in args.shapes.split(",") if s]
        ticks = args.ticks

    t0 = time.time()
    ladder = run_ladder(devices, shapes, ticks, args.quick,
                        demand_format=args.mesh_demand_format, device=dev)
    # sparse-tick rungs: always in full mode, opt-in (--sparse) in quick;
    # --mesh-hosts re-runs them over a multi-process mesh
    sparse = []
    if args.sparse or not args.quick:
        sparse = run_sparse_ladder(
            devices, args.quick, demand_format=args.mesh_demand_format,
            device=dev)
    if args.mesh_hosts > 1:
        init_hosts(args.mesh_hosts, args.mesh_proc_id,
                   args.mesh_coordinator)
        sparse += run_sparse_ladder(
            devices, args.quick, demand_format=args.mesh_demand_format,
            dcn=True, device=dev)
    measured = [r for r in ladder if r.get("path") != "compare"]
    compares = [r for r in ladder if r.get("path") == "compare"]
    divergences = [r["fire_set_divergence"] for r in ladder + sparse
                   if r.get("fire_set_divergence") is not None]
    out = {
        "multichip_backend": dev.type,
        "multichip_devices": devices,
        "multichip_ticks_total": sum(r["ticks"] for r in measured),
        # a rung that raises fails the run: none is recorded as failed
        "multichip_failed_configs": 0,
        "multichip_ladder": ladder,
        "multichip_sparse_ladder": sparse,
        "multichip_demand_format": args.mesh_demand_format,
        "multichip_divergence_total": sum(divergences),
        "multichip_divergence_checks": len(divergences),
        "multichip_bytes_ratio_worst": max(
            (c["bytes_ratio"] for c in compares), default=0.0),
        "multichip_wall_s": round(time.time() - t0, 1),
        "git_rev": git_rev(),
        "generated_at_utc": utc_now(),
    }
    if args.out:
        tail = "; ".join(
            f"{c['devices']}dev/{c['mesh']}: bytes x{c['bytes_ratio']} "
            f"p99 x{c['p99_ratio']}" for c in compares)
        with open(args.out, "w") as f:
            json.dump({
                "n_devices": max(devices), "rc": 0, "ok": True,
                "skipped": False, "git_rev": out["git_rev"],
                "generated_at_utc": out["generated_at_utc"],
                "tail": f"bench_mesh ladder OK: {tail}",
                "ladder": ladder + sparse,
            }, f, indent=1)
        log(f"sidecar written: {args.out}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
