"""One process of a multi-host mesh planner run of the port (CPU shards,
gloo), for ``tests/test_torch_multihost.py``.

Usage: torch_mesh_worker.py RANK NPROCS SHARDS KIND PORT
Builds the global mesh of SHARDS CPU shards (KIND ``1d``: a jobs mesh;
``2d``: SHARDS/2 x 2) over NPROCS processes joined by
``torch.distributed`` (gloo, ``tcp://127.0.0.1:PORT``), installs the seeded
state of :func:`state`, plans a fused window and a tick, and prints one
line per planned second and the carried state:
  PLAN <sec> <fired rows> <assigned nodes> <overflow> <total fired>
  STATE <load> <rem_cap>
With NPROCS = 1 this is the single-process reference of the same mesh.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

J, N, W, T0 = 2048, 64, 4, 1_753_000_000
SPECS = ("* * * * * *", "*/2 * * * * *", "@every 3s", "0 * * * * *")


def state() -> dict:
    from cronsun_tpu_torch.synth import synth_state
    return synth_state(J, N, seed=7, specs=SPECS, node_cap=3)


def main():
    rank, nprocs, shards, kind, port = sys.argv[1:6]
    rank, nprocs, shards = int(rank), int(nprocs), int(shards)
    import torch
    import torch.distributed as dist
    # several of these processes share the cores: one intra-op thread each
    torch.set_num_threads(1)
    if nprocs > 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=nprocs, rank=rank)
    from cronsun_tpu_torch.convert import install_mesh_state
    from cronsun_tpu_torch.parallel.mesh import (Sharded2DTickPlanner,
                                                 ShardedTickPlanner,
                                                 make_mesh, make_mesh2d)
    if kind == "1d":
        p = ShardedTickPlanner(make_mesh(shards, device="cpu"), J, N,
                               max_fire_bucket=1024)
    else:
        p = Sharded2DTickPlanner(make_mesh2d(shards // 2, 2, device="cpu"),
                                 J, N, max_fire_bucket=1024)
    assert p._multiprocess == (nprocs > 1)
    install_mesh_state(p, state())
    plans = p.plan_window(T0, W) + [p.plan(T0 + W)]
    for pl in plans:
        print("PLAN", pl.epoch_s, ",".join(map(str, pl.fired.tolist())),
              ",".join(map(str, pl.assigned.tolist())), pl.overflow,
              pl.total_fired, flush=True)
    print("STATE", ",".join(map(repr, p.load.tolist())),
          ",".join(map(str, p.rem_cap.tolist())), flush=True)
    if nprocs > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
