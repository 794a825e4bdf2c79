"""Delta checkpoint chains across the packages: a base save plus one delta
element (five jobs added, one deleted after the base) written by one
package's scheduler restores in the other's, and the restored service's
first window equals the saver's, in both directions."""

import pytest

from cronsun_tpu.core import Job, JobRule, KIND_ALONE, KIND_COMMON
from cronsun_tpu.sched import SchedulerService as JaxService
from cronsun_tpu_torch.sched import SchedulerService as PortService
from test_torch_service_fleet import (KS, first_window, put_job, saved,
                                      seeded_store, service)
from torch_parity import one_torch_thread  # noqa: F401


def churn(store):
    """Five jobs added and one deleted, on the store."""
    for i in range(5):
        put_job(store, Job(
            id=f"d{i}", group="default", name=f"d{i}", command="true",
            kind=KIND_ALONE if i % 2 else KIND_COMMON,
            rules=[JobRule(id="r", timer=f"*/{i + 2} * * * * *",
                           nids=["node-0", "node-1"])]))
    victim = next(iter(store.get_prefix(KS.cmd))).key
    store.delete(victim)
    return tuple(victim[len(KS.cmd):].split("/"))


@pytest.mark.parametrize("saver,loader", [(JaxService, PortService),
                                          (PortService, JaxService)],
                         ids=["jax-to-port", "port-to-jax"])
def test_base_plus_delta_restores_across_the_packages(tmp_path, saver,
                                                      loader):
    store = seeded_store()
    ckpt = str(tmp_path / "ckpt")
    svc, ep = saved(saver, store, ckpt)
    victim = churn(store)
    svc.step(now=ep)
    ep = svc._next_epoch
    if svc._pending_plan is not None:
        svc._resolve_handle(svc._pending_plan[1])
    assert svc.checkpoint_save(kind="delta")["kind"] == "delta"
    want = first_window(svc, ep)
    restored = service(loader, store, ckpt)
    try:
        assert restored.checkpoint_restored
        # the base lacks the churn: only the folded delta carries it
        added = {("default", f"d{i}") for i in range(5)}
        assert added <= set(svc.jobs) and victim not in svc.jobs
        assert set(restored.jobs) == set(svc.jobs)
        assert want and first_window(restored, ep) == want
    finally:
        restored.stop()
        svc.stop()
