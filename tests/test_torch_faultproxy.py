"""The port's fault proxy, ``cronsun_tpu_torch.chaos.faultproxy``, against
the JAX package's, on the CPU.

A fault schedule is a pure function of its seed and rules: both packages
must serialize the same schedule to the same bytes.  On the wire, the same
op script through a proxy under the same schedule must give the same
transcript (every reply, and the proxy's fault counts) from the port's
client, proxy and server as from the JAX package's.
"""

import pytest

from cronsun_tpu.chaos import faultproxy as jax_fp
from cronsun_tpu.store.memstore import MemStore as JaxMemStore
from cronsun_tpu.store.remote import RemoteStore as JaxRemoteStore
from cronsun_tpu.store.remote import StoreServer as JaxStoreServer
from cronsun_tpu_torch.chaos import faultproxy as port_fp
from cronsun_tpu_torch.store.memstore import MemStore as PortMemStore
from cronsun_tpu_torch.store.remote import RemoteStore as PortRemoteStore
from cronsun_tpu_torch.store.remote import StoreServer as PortStoreServer
from torch_parity import one_torch_thread, time_limit  # noqa: F401

RULE_SETS = {
    # the smoke drill's wire faults
    "smoke": [("delay", {"prob": 0.2, "ms": 15}), ("dup", {"prob": 0.10}),
              ("reorder", {"prob": 0.05})],
    # the shard-partition drill's timed sever, and a drop beside it
    "sever": [("sever", {"start": 0.5, "end": 1.7}),
              ("drop", {"prob": 0.3, "direction": "c2s"})],
    # one of each kind, directional and windowed
    "all": [("delay", {"prob": 0.5, "ms": 2.5, "direction": "s2c"}),
            ("drop", {"prob": 0.01, "start": 1.0, "end": 2.0}),
            ("dup", {"prob": 0.4, "direction": "c2s"}),
            ("reorder", {"prob": 0.25}), ("blackhole", {"start": 3.0}),
            ("sever", {"start": 4.0, "end": 4.25})],
}


def schedule(mod, seed, rules):
    s = mod.FaultSchedule(seed)
    for kind, kw in rules:
        s.add(kind, **kw)
    return s


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("seed", [0, 7, 1099, 2**31 + 5])
def test_schedule_bytes_are_identical_across_the_packages(seed, rules):
    ref = schedule(jax_fp, seed, RULE_SETS[rules]).schedule_bytes()
    got = schedule(port_fp, seed, RULE_SETS[rules]).schedule_bytes()
    assert got == ref
    assert got.startswith(f"seed={seed}\n".encode())


def test_schedule_bytes_cover_every_decision_and_a_removed_rule():
    """The serialization's own knobs (connections, lines) and a rule
    removed from the set give the same bytes in both packages."""
    for mod in (jax_fp, port_fp):
        s = schedule(mod, 3, RULE_SETS["all"])
        s.remove(s.snapshot()[1].rule_id)
        assert len(s.snapshot()) == len(RULE_SETS["all"]) - 1
    ref = schedule(jax_fp, 3, RULE_SETS["all"])
    got = schedule(port_fp, 3, RULE_SETS["all"])
    for s in (ref, got):
        s.remove(s.snapshot()[1].rule_id)
    assert got.schedule_bytes(conns=9, lines=1000) == \
        ref.schedule_bytes(conns=9, lines=1000)
    assert got.schedule_bytes() != ref.schedule_bytes(conns=3)


def test_bad_rules_are_refused_alike():
    for mod in (jax_fp, port_fp):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultSchedule(1).add("corrupt")
        with pytest.raises(ValueError, match="bad direction"):
            mod.FaultSchedule(1).add("drop", direction="up")


def op_script(store) -> list:
    """KV ops with their replies, revisions included: both servers start
    empty, so a reply differs only if the wire does."""
    out = []
    for i in range(40):
        rev = store.put(f"/fp/k{i:02d}", f"v{i}")
        out.append(("put", i, rev))
    for i in range(0, 40, 3):
        kv = store.get(f"/fp/k{i:02d}")
        out.append(("get", i, kv.value, kv.mod_rev))
    out.append(("prefix", [(kv.key, kv.value, kv.mod_rev)
                           for kv in store.get_prefix("/fp/k1")]))
    out.append(("count", store.count_prefix("/fp/")))
    for i in range(5, 40, 7):
        out.append(("delete", i, store.delete(f"/fp/k{i:02d}")))
    out.append(("count", store.count_prefix("/fp/")))
    out.append(("missing", store.get("/fp/nope")))
    return out


def transcript(server_cls, store_cls, client_cls, proxy_mod, seed):
    srv = server_cls(store_cls()).start()
    sched = schedule(proxy_mod, seed, [
        ("delay", {"prob": 0.3, "ms": 2}),
        ("dup", {"prob": 0.15, "direction": "s2c"}),
        ("reorder", {"prob": 0.1, "direction": "s2c"})])
    proxy = proxy_mod.FaultProxy(("127.0.0.1", srv.port), sched).start()
    cli = client_cls("127.0.0.1", proxy.port, timeout=10)
    try:
        ops = op_script(cli)
        stats = dict(proxy.stats)
    finally:
        cli.close()
        proxy.stop()
        srv.stop()
    return ops, stats


@pytest.mark.parametrize("seed", [5, 77])
def test_port_trio_gives_the_jax_trio_transcript(seed):
    """Port client -> port proxy -> port server against the JAX trio,
    under one schedule: equal replies, and equal fault counts (the
    decisions are hashes of the line ordinals, which both clients send
    alike)."""
    with time_limit(120, "fault proxy transcripts"):
        ref = transcript(JaxStoreServer, JaxMemStore, JaxRemoteStore,
                         jax_fp, seed)
        got = transcript(PortStoreServer, PortMemStore, PortRemoteStore,
                         port_fp, seed)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[1]["dup"] > 0 and got[1]["delay"] > 0


def test_a_stopped_port_proxy_leaves_no_thread():
    """The port's ``FaultProxy.stop`` wakes its accept thread and joins
    it: nothing named after the proxy outlives it."""
    import threading
    srv = PortStoreServer(PortMemStore()).start()
    proxy = port_fp.FaultProxy(("127.0.0.1", srv.port),
                               port_fp.FaultSchedule(3),
                               name="fp-stop-probe").start()
    cli = PortRemoteStore("127.0.0.1", proxy.port, timeout=10)
    try:
        cli.put("/fp/x", "1")
    finally:
        cli.close()
        proxy.stop()
        srv.stop()
    with time_limit(10, "proxy threads"):
        while any(t.name.startswith("fp-stop-probe")
                  for t in threading.enumerate()):
            threading.Event().wait(0.05)
