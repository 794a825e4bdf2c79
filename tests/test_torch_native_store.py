"""The port's launcher of the native coordination store,
``cronsun_tpu_torch.store.native``: where it finds the binary, how a start
that never reaches READY fails, and a port client served by it."""

import os
import stat

import pytest

from cronsun_tpu_torch.store import native


def _script(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_find_binary_takes_the_env_override_first(monkeypatch, tmp_path):
    fake = _script(tmp_path / "stored", "exit 0\n")
    monkeypatch.setenv("CRONSUN_STORED", fake)
    assert native.find_binary() == fake


def test_a_start_without_ready_raises_with_what_the_server_printed(
        tmp_path):
    fake = _script(tmp_path / "stored", "echo \"bind $2:$4 failed\"\n"
                                        "exit 1\n")
    with pytest.raises(RuntimeError, match="bind 127.0.0.1:0 failed"):
        native.NativeStoreServer(fake)


def test_the_ready_line_gives_host_and_port_and_stop_ends_the_child(
        tmp_path):
    fake = _script(tmp_path / "stored", "echo READY 127.0.0.1:7123\n"
                                        "exec sleep 60\n")
    srv = native.NativeStoreServer(fake)
    assert (srv.host, srv.port) == ("127.0.0.1", 7123)
    srv.stop()
    assert srv._proc.returncode is not None


def test_the_native_store_serves_the_port_client():
    from cronsun_tpu_torch.store.remote import RemoteStore
    binary = native.find_binary()
    if binary is None or not os.access(binary, os.X_OK):
        pytest.skip("native/cronsun-stored neither built nor buildable")
    srv = native.NativeStoreServer(binary)
    try:
        store = RemoteStore(srv.host, srv.port, timeout=30)
        store.put("/cronsun/t/a", "1")
        assert store.get("/cronsun/t/a").value == "1"
        store.close()
    finally:
        srv.stop()
    assert srv._proc.returncode is not None
