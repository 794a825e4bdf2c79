"""Scheduler services over mesh planners: checkpoints of a single-process
mesh restore across the packages (the JAX package's mesh checkpoint in the
port, the port's in the JAX package), with the restored service's first
window equal to the saver's; a checkpoint of another mesh shape cold-loads;
a multi-host (proxied) planner refuses checkpoints; and the service
publishes the mesh's leased metrics snapshot."""

import json

import pytest

from cronsun_tpu.parallel import mesh as jax_mesh
from cronsun_tpu.sched import SchedulerService as JaxService
from cronsun_tpu_torch.parallel import mesh as port_mesh
from cronsun_tpu_torch.parallel.hostsync import PlannerSyncProxy
from cronsun_tpu_torch.sched import SchedulerService as PortService
from test_torch_service_fleet import J, KS, N, first_window, seeded_store, \
    service
from torch_parity import cpu_mesh, one_torch_thread  # noqa: F401


def planner(pkg, kind):
    """A mesh planner of the service's capacities: ``kind`` "1d" (2 shards)
    or "2d" (2 x 2)."""
    kw = dict(job_capacity=J, node_capacity=N, max_fire_bucket=J)
    if pkg == "jax":
        if kind == "1d":
            return jax_mesh.ShardedTickPlanner(jax_mesh.make_mesh(2),
                                               impl="jnp", **kw)
        return jax_mesh.Sharded2DTickPlanner(jax_mesh.make_mesh2d(2, 2),
                                             **kw)
    if kind == "1d":
        return port_mesh.ShardedTickPlanner(cpu_mesh(2), **kw)
    return port_mesh.Sharded2DTickPlanner(cpu_mesh(2, 2), **kw)


def mesh_service(pkg, kind, store, ckpt):
    cls = JaxService if pkg == "jax" else PortService
    return service(cls, store, ckpt, planner=planner(pkg, kind))


def saved(pkg, kind, store, ckpt):
    """A mesh service that stepped two windows and saved a full
    checkpoint; with the next window's epoch."""
    svc = mesh_service(pkg, kind, store, ckpt)
    t = 1_753_000_000
    for _ in range(2):
        svc.step(now=t)
        t = svc._next_epoch
    assert svc.checkpoint_save(kind="full")["kind"] == "full"
    return svc, t


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("saver,loader", [("jax", "port"), ("port", "jax")])
def test_mesh_checkpoint_restores_across_the_packages(
        forced_host_devices, tmp_path, kind, saver, loader):
    store = seeded_store()
    ckpt = str(tmp_path / "ckpt")
    svc, ep = saved(saver, kind, store, ckpt)
    restored = mesh_service(loader, kind, store, ckpt)
    try:
        assert restored.checkpoint_restored
        assert restored._mesh_topology() == svc._mesh_topology() == {
            "kind": "ShardedTickPlanner" if kind == "1d"
            else "Sharded2DTickPlanner",
            "dj": 2, "dn": 1 if kind == "1d" else 2,
            "devices": 2 if kind == "1d" else 4}
        want = first_window(svc, ep)
        assert want and first_window(restored, ep) == want
    finally:
        restored.stop()
        svc.stop()


def test_mesh_checkpoint_of_another_shape_cold_loads(forced_host_devices,
                                                     tmp_path):
    """A 1-D mesh checkpoint (the JAX package's) against a port 2-D mesh, and
    against the port's single-device planner: both cold-load."""
    store = seeded_store()
    ckpt = str(tmp_path / "ckpt")
    svc, _ = saved("jax", "1d", store, ckpt)
    svc.stop()
    other = port_mesh.Sharded2DTickPlanner(cpu_mesh(2, 1), job_capacity=J,
                                           node_capacity=N)
    assert (other.J, other.N) == (J, N)
    for kw in ({"planner": other}, {}):
        cold = service(PortService, store, ckpt, **kw)
        try:
            assert not cold.checkpoint_restored
            assert cold.jobs          # loaded from the store instead
        finally:
            cold.stop()


def test_multi_host_proxy_refuses_checkpoints(tmp_path):
    store = seeded_store()
    proxied = PlannerSyncProxy(planner("port", "1d"))
    svc = service(PortService, store, str(tmp_path / "ckpt"),
                  planner=proxied)
    try:
        assert svc.checkpoint_dir is None
    finally:
        svc.stop()
    plain = service(PortService, store, str(tmp_path / "ckpt2"),
                    planner=planner("port", "1d"))
    try:
        assert plain.checkpoint_dir is not None
    finally:
        plain.stop()


def test_scheduler_publishes_mesh_metrics(tmp_path):
    """A port service over a mesh planner publishes the component "mesh"
    leased snapshot, rendered by /v1/metrics as cronsun_mesh_tick_*."""
    store = seeded_store()
    svc = service(PortService, store, None, planner=planner("port", "2d"))
    try:
        svc.step(now=1_753_000_000)
        svc._mesh_metrics.maybe_publish()
        kv = store.get(KS.metrics_key("mesh", svc.node_id))
        snap = json.loads(kv.value)
        assert snap["devices"] == 4 and snap["shard_bids"] == 1
        assert snap["ticks_total"] == 4 and snap["tick_p50_ms"] > 0
    finally:
        svc.stop()
