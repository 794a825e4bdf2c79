"""The port's store server and clients against the JAX package's: one fixed
script of store operations gives the same results and the same watch
events in every pairing of {JAX ``StoreServer``, port ``StoreServer``,
native ``cronsun-stored``} x {JAX ``RemoteStore``, port ``RemoteStore``};
the port's sharded client routes every key to the shard the JAX
package's picks; both refuse a mismatched shard map and a malformed
replica group alike."""

import time

import pytest

from cronsun_tpu.store import MemStore as JaxMemStore
from cronsun_tpu.store import sharded as jax_sharded
from cronsun_tpu.store.native import NativeStoreServer, find_binary
from cronsun_tpu.store.remote import RemoteStore as JaxRemote
from cronsun_tpu.store.remote import StoreServer as JaxServer
from cronsun_tpu_torch.core import Keyspace
from cronsun_tpu_torch.store import MemStore as PortMemStore
from cronsun_tpu_torch.store import sharded as port_sharded
from cronsun_tpu_torch.store.remote import RemoteStore as PortRemote
from cronsun_tpu_torch.store.remote import StoreServer as PortServer
from cronsun_tpu_torch.synth import seed_service_store

HISTORY = 32       # events a server keeps for watch replay
CLIENTS = {"jax": JaxRemote, "port": PortRemote}


def _server(kind):
    if kind == "jax":
        return JaxServer(JaxMemStore(history=HISTORY)).start()
    if kind == "port":
        return PortServer(PortMemStore(history=HISTORY)).start()
    binary = find_binary()
    if binary is None:
        pytest.skip("native store binary unavailable")
    return NativeStoreServer(binary=binary, history=HISTORY)


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out"
        time.sleep(0.05)


def _script(c):
    """The fixed operation script; returns its transcript with lease ids
    replaced by their grant order."""
    leases = {}

    def kv(x):
        if x is None:
            return None
        return (x.key, x.value, x.create_rev, x.mod_rev,
                leases.get(x.lease, x.lease))

    out = []
    r1 = c.put("/w/a", "1")
    out += [("put", r1), ("put", c.put("/w/a", "2")),
            ("get", kv(c.get("/w/a"))), ("get-missing", c.get("/w/none"))]
    out.append(("put_many", c.put_many([[f"/w/m/{i}", str(i)]
                                        for i in range(5)])))
    out.append(("prefix", [kv(x) for x in c.get_prefix("/w/")]))
    out.append(("count", c.count_prefix("/w/m/")))
    out.append(("get_many", [kv(x) for x in c.get_many(
        ["/w/a", "/w/x", "/w/m/1"])]))
    out.append(("put_if_absent", c.put_if_absent("/w/lock", "me"),
                c.put_if_absent("/w/lock", "you")))
    mod = c.get("/w/lock").mod_rev
    out.append(("cas", c.put_if_mod_rev("/w/lock", "me2", mod),
                c.put_if_mod_rev("/w/lock", "me3", mod),
                kv(c.get("/w/lock"))))
    # a watch from the first revision replays everything above, then
    # follows the rest of the script
    w = c.watch("/w/", start_rev=r1)
    keep, gone = c.grant(30), c.grant(1)
    leases.update({keep: "lease-keep", gone: "lease-gone"})
    c.put("/w/lease/keep", "k", lease=keep)
    c.put("/w/lease/gone", "g", lease=gone)
    out.append(("keepalive", c.keepalive(keep)))
    _wait(lambda: c.get("/w/lease/gone") is None)      # expired by TTL
    out.append(("expired", kv(c.get("/w/lease/keep")), c.keepalive(gone)))
    out.append(("revoke", c.revoke(keep), c.get("/w/lease/keep")))
    # one key left for delete_prefix: the Python stores delete a prefix in
    # stripe order, the native one in key order
    out.append(("delete", c.delete("/w/a"), c.delete("/w/a"),
                c.delete_many([f"/w/m/{i}" for i in range(4)]),
                c.delete_prefix("/w/m/")))
    end = c.put("/w/zz-end", "end")
    events = []

    def drained():
        while (ev := w.get(timeout=0.05)) is not None:
            events.append((ev.type, kv(ev.kv), kv(ev.prev_kv)))
        return events and events[-1][1][0] == "/w/zz-end"
    _wait(drained)
    w.close()
    out.append(("events", events))
    for i in range(HISTORY + 8):
        c.put(f"/w/fill/{i}", "v")
    with pytest.raises(Exception) as exc:
        c.watch("/w/", start_rev=end)
    out.append(("compacted", type(exc.value).__name__))
    out.append(("rev", c.rev()))
    return out


_reference = {}


def _transcript(server_kind, client_kind):
    srv = _server(server_kind)
    c = CLIENTS[client_kind](srv.host, srv.port)
    try:
        return _script(c)
    finally:
        c.close()
        srv.stop()


@pytest.mark.parametrize("client", sorted(CLIENTS))
@pytest.mark.parametrize("server", ["jax", "port", "native"])
def test_wire_matrix_gives_one_transcript(server, client):
    if "ref" not in _reference:
        _reference["ref"] = _transcript("jax", "jax")
    got = _transcript(server, client)
    assert got == _reference["ref"]
    ops = dict((t[0], t[1:]) for t in got)
    assert ops["compacted"] == ("CompactedError",)
    assert ops["put_if_absent"] == (True, False)
    assert ops["cas"][:2] == (True, False)
    # deletes: the expired lease's key, the revoked one's, /w/a, 5 of /w/m/
    events, = ops["events"]
    assert [e[0] for e in events].count("DELETE") == 8


@pytest.fixture
def three_port_servers():
    servers = [PortServer(PortMemStore()).start() for _ in range(3)]
    yield servers
    for s in servers:
        s.stop()


def test_sharded_routing_matches_the_jax_client(three_port_servers):
    addrs = [f"{s.host}:{s.port}" for s in three_port_servers]
    ks = Keyspace()
    port = port_sharded.connect_sharded(addrs, timeout=30.0)
    jax = jax_sharded.connect_sharded(addrs, timeout=30.0)
    try:
        assert isinstance(port, port_sharded.ShardedStore)
        seed_service_store(port, ks, 400, 32, 1_753_000_000)
        port.put(ks.leader, "sched-a")
        port.put(ks.dispatch_bundle_key("bn00001", 1_753_000_004), '["g/j"]')
        keys = 0
        for i, srv in enumerate(three_port_servers):
            for kv in srv.store.get_prefix(ks.prefix + "/"):
                keys += 1
                assert jax_sharded.shard_index(kv.key, 3, ks.prefix) == i
                assert jax.get(kv.key).value == kv.value
        assert keys >= 400 + 32 + 32     # jobs, nodes, groups at least
        assert sorted(kv.key for kv in jax.get_prefix(ks.cmd)) == \
            sorted(kv.key for kv in port.get_prefix(ks.cmd))
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("pkg", [jax_sharded, port_sharded],
                         ids=["jax", "port"])
def test_shard_map_pin_refuses_a_mismatched_count(pkg, three_port_servers):
    addrs = [f"{s.host}:{s.port}" for s in three_port_servers]
    # the other package lays the shard set out first: the pin is shared
    other = port_sharded if pkg is jax_sharded else jax_sharded
    other.connect_sharded(addrs, timeout=10.0).close()
    for subset in (addrs[:2], addrs[:1]):
        with pytest.raises(RuntimeError, match="shard-map mismatch"):
            pkg.connect_sharded(subset, timeout=10.0)
    pkg.connect_sharded(addrs, timeout=10.0).close()


@pytest.mark.parametrize("group", ["127.0.0.1:1||127.0.0.1:2",
                                   "|127.0.0.1:1", "127.0.0.1:1|"])
def test_malformed_replica_group_raises_the_same_error(group):
    errors = []
    for pkg in (jax_sharded, port_sharded):
        with pytest.raises(ValueError) as exc:
            pkg.connect_sharded([group])
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "empty member" in errors[0]
