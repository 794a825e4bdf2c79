"""The port's store, result-store, agent and web launchers against the JAX
package's: the same flags, and the same refusals with the same exit code
and message (``--repl-group`` with ``--native``, TLS with ``--native``,
``--native`` with no binary, a duplicate node id, bad flag values); the
native store's flags pass through and its launcher exits when the daemon
dies.

Normalised: the log lines' timestamps and the node's pid in the duplicate
refusal."""

import json
import os
import re
import signal
import subprocess

import pytest

from torch_fleet import PKG, Proc, run_cli

ROLES = ("store", "logd", "node", "web")
_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d ", re.M)


def _both(role, *args):
    """(rc, output) of the JAX launcher and of the port's, for the same
    arguments, with log timestamps stripped."""
    return [(rc, _STAMP.sub("", out)) for rc, out in (
        run_cli(f"{PKG[pkg]}.bin.{role}", *args) for pkg in ("jax", "port"))]


def _options(help_text):
    """``--help`` from its usage line on, minus the module docstring."""
    usage, _, rest = help_text.partition("\n\n")
    return usage + "\n" + rest[rest.index("options:"):]


@pytest.mark.parametrize("role", ROLES)
def test_the_launchers_take_the_same_flags(role):
    (rc_j, jax_help), (rc_p, port_help) = _both(role, "--help")
    assert rc_j == rc_p == 0
    assert _options(port_help) == _options(jax_help)


REFUSALS = [
    ("store", ["--shards", "0"]),
    ("store", ["--repl-group", "a|", "--port", "0"]),
    ("store", ["--repl-group", "a|b", "--shards", "2"]),
    ("store", ["--native", "--repl-group", "127.0.0.1:1|127.0.0.1:2",
               "--port", "0"]),
    ("logd", ["--retain", "0"]),
    ("logd", ["--shards", "0"]),
    ("logd", ["--hot-days", "-1"]),
]


@pytest.mark.parametrize("role,args", REFUSALS,
                         ids=[f"{r}:{' '.join(a)}" for r, a in REFUSALS])
def test_refusals_match_the_jax_launchers(role, args):
    (rc_j, out_j), (rc_p, out_p) = _both(role, *args)
    assert rc_j == 2 and "error:" in out_j
    assert (rc_p, out_p) == (rc_j, out_j)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    subprocess.run(["sh", "scripts/gen_certs.sh", str(d)], check=True,
                   capture_output=True, cwd=os.path.dirname(
                       os.path.dirname(os.path.abspath(__file__))))
    return d


@pytest.mark.parametrize("role,section", [("store", "store_tls"),
                                          ("logd", "log_tls")])
def test_tls_with_native_exits_2_with_the_terminator_hint(
        tmp_path, certs, role, section):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({section: {
        "cert": str(certs / "server.pem"), "key": str(certs / "server.key"),
        "ca": str(certs / "ca.pem")}}))
    (rc_j, out_j), (rc_p, out_p) = _both(role, "--native", "--port", "0",
                                         "--conf", str(conf))
    assert rc_j == 2 and "terminate TLS in front of the native" in out_j
    assert (rc_p, out_p) == (rc_j, out_j)


@pytest.mark.parametrize("role,module", [("store", "store.native"),
                                         ("logd", "logsink.native")])
def test_native_with_no_binary_fails_as_the_jax_launcher_fails(
        monkeypatch, role, module):
    """No binary: the launcher raises the JAX launcher's FileNotFoundError;
    it never serves the Python backend instead."""
    import importlib
    got = []
    for pkg in ("jax", "port"):
        mod = importlib.import_module(f"{PKG[pkg]}.{module}")
        monkeypatch.setattr(mod, "find_binary", lambda *a, **k: None)
        main = importlib.import_module(f"{PKG[pkg]}.bin.{role}").main
        with pytest.raises(FileNotFoundError) as e:
            main(["--native", "--port", "0"])
        got.append(str(e.value))
    assert got[1] == got[0] and "not found" in got[0]


def test_a_duplicate_node_id_exits_1_in_both_launchers(tmp_path):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"log_db": str(tmp_path / "logs.db"),
                                "node_ttl": 30}))
    store = Proc("cronsun_tpu_torch.bin.store", "--port", "0")
    try:
        addr = store.ready()
        first = Proc("cronsun_tpu_torch.bin.node", "--store", addr,
                     "--conf", str(conf), "--node-id", "dup")
        first.ready()
        outs = _both("node", "--store", addr, "--conf", str(conf),
                     "--node-id", "dup")
        assert first.stop() == 0
    finally:
        store.stop()
    pid = re.compile(r"pid \d+")
    (rc_j, out_j), (rc_p, out_p) = [(rc, pid.sub("pid N", o))
                                    for rc, o in outs]
    assert rc_j == 1 and "already registered by live pid N" in out_j
    assert (rc_p, out_p) == (rc_j, out_j)


def _children(pid):
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, IndexError, ValueError):
                continue
    return out


def test_the_native_store_takes_the_flags_and_exits_when_the_daemon_dies(
        tmp_path):
    from cronsun_tpu_torch.bin.common import connect_store
    from cronsun_tpu_torch.store.native import find_binary
    if find_binary() is None:
        pytest.skip("native/cronsun-stored neither built nor buildable")
    wal = tmp_path / "st.wal"
    p = Proc("cronsun_tpu_torch.bin.store", "--native", "--port", "0",
             "--shards", "2", "--wal", str(wal), "--stripes", "4",
             "--token", "s3cret")
    try:
        addr = p.ready()
        assert len(addr.split(",")) == 2
        store = connect_store(addr, token="s3cret")
        store.put("/cronsun/t/a", "1")
        assert store.get("/cronsun/t/a").value == "1"
        store.close()
        assert os.path.exists(f"{wal}.s0") and os.path.exists(f"{wal}.s1")
        kids = _children(p.p.pid)
        assert len(kids) == 2
        os.kill(kids[0], signal.SIGKILL)
        assert p.wait(timeout=30) == 1
        assert "native store exited rc=-9; shutting down" in p.output()
    finally:
        p.stop()
        for k in _children(p.p.pid):
            os.kill(k, signal.SIGKILL)


def test_the_python_store_and_logd_serve_shard_sets_with_their_sidecars(
        tmp_path):
    from cronsun_tpu_torch.bin.common import connect_store
    from cronsun_tpu_torch.logsink.sharded import ShardedJobLogStore, \
        connect_sharded_sink
    st = Proc("cronsun_tpu_torch.bin.store", "--port", "0", "--shards", "2",
              "--wal", str(tmp_path / "st.wal"), "--health-port", "0")
    lg = Proc("cronsun_tpu_torch.bin.logd", "--port", "0", "--shards", "2",
              "--db", str(tmp_path / "logs.db"))
    try:
        store = connect_store(st.ready())
        store.put("/cronsun/t/a", "1")
        store.close()
        sink = connect_sharded_sink(lg.ready().split(","))
        assert isinstance(sink, ShardedJobLogStore)
        assert sink.stat_overall()["total"] == 0
        sink.close()
        for i in range(2):
            assert os.path.exists(tmp_path / f"st.wal.s{i}")
            assert os.path.exists(tmp_path / f"logs.db.s{i}")
    finally:
        rcs = [lg.stop(), st.stop()]
    assert rcs == [0, 0]
