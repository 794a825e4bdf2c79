"""The port's launcher in-process: refusals, device resolution, conf parity
with the JAX package, and the single-device entry step against
``__graft_entry__.entry``."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from cronsun_tpu import conf as jax_conf
from cronsun_tpu.bin import sched as jax_sched
from cronsun_tpu_torch import conf as port_conf
from cronsun_tpu_torch import entry as port_entry
from cronsun_tpu_torch.bin import sched as port_sched
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# flag errors that exit 2 before any store, rendezvous or card is touched
MESH_FLAG_ERRORS = [
    (["--mesh2d", "4"], "--mesh2d wants DJxDN"),
    (["--mesh2d", "0x2"], "--mesh2d wants DJxDN"),
    (["--mesh", "4", "--mesh2d", "2x2"], "mutually exclusive"),
    (["--mesh-hosts", "2"], "--mesh-hosts requires --mesh D"),
]


@pytest.mark.parametrize("argv,reason", [
    *MESH_FLAG_ERRORS,
    (["--mesh-hosts", "2", "--mesh", "1"], "--mesh-hosts requires"),
    (["--mesh-hosts", "2", "--mesh", "3"], "do not divide over"),
    (["--mesh-hosts", "2", "--mesh2d", "3x1"], "do not divide over"),
    (["--mesh-hosts", "2", "--mesh", "4", "--mesh-proc-id", "2"],
     "--mesh-proc-id 2 out of range"),
], ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_jax_only_and_mesh_flags_exit_2(argv, reason, capsys):
    assert port_sched.main(["--store", "127.0.0.1:1", *argv]) == 2
    err = capsys.readouterr().err
    assert reason in err and err.count("\n") == 1, err


@pytest.mark.parametrize("argv,reason", MESH_FLAG_ERRORS,
                         ids=lambda v: v if isinstance(v, str)
                         else " ".join(v))
def test_mesh_flag_errors_match_the_jax_launcher(argv, reason, capsys):
    assert jax_sched.main(["--store", "127.0.0.1:1", *argv]) == 2
    jax_err = capsys.readouterr().err
    assert port_sched.main(["--store", "127.0.0.1:1", *argv]) == 2
    assert capsys.readouterr().err == jax_err
    assert reason in jax_err


@pytest.mark.parametrize("argv", [
    ["--partitions", "2", "--partition", "2"],
    ["--partitions", "0"],
    ["--partitions", "3", "--partition", "-1"],
], ids=" ".join)
def test_partition_range_matches_the_jax_launcher(argv, capsys):
    assert jax_sched.main(["--store", "127.0.0.1:1", *argv]) == 2
    jax_err = capsys.readouterr().err
    assert port_sched.main(["--store", "127.0.0.1:1", *argv]) == 2
    assert capsys.readouterr().err == jax_err
    assert "out of range" in jax_err


def test_no_card_and_no_device_cpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_sched.main(["--store", "127.0.0.1:1"]) != 0
    assert "device='cpu'" in capsys.readouterr().err


def _every_field(tmp_path):
    """A conf that sets every field of Config to a non-default value."""
    data = {
        "prefix": "/other", "node_ttl": 7, "lock_ttl": 99, "proc_ttl": 77,
        "proc_req": 3, "timezone": "Europe/Berlin", "window_s": 2,
        "pipelined_step": False, "job_capacity": 2048, "node_capacity": 96,
        "default_node_cap": 12, "log_db": "x.db", "log_addr": "h:1",
        "log_token": "lt", "store_token": "st",
        "store_tls": {"ca": "ca.pem", "cert": "c.pem", "key": "k.pem",
                      "hostname": "store.local"},
        "log_tls": {"ca": "lca.pem", "hostname": "logd.local"},
        "checkpoint_dir": "@pwd@/ckpt", "checkpoint_interval": 5,
        "checkpoint_delta": False, "checkpoint_rebase_chain": 8,
        "checkpoint_rebase_bytes": 1024, "trace_sample_shift": 0,
        "slo_eval_s": 3, "compile_cache": "",
        "security": {"open": True, "users": ["a"], "exts": [".sh"]},
        "mail": {"enable": True, "host": "smtp", "port": 2525, "user": "u",
                 "password": "p", "to": ["t@x"], "keepalive": 0,
                 "http_api": "http://m"},
        "web": {"host": "127.0.0.1", "port": 1, "session_ttl": 60,
                "auth_enabled": False},
    }
    names = {f.name for f in dataclasses.fields(jax_conf.Config)
             if not f.name.startswith("_")}
    assert set(data) == names, names ^ set(data)
    base = tmp_path / "base.json"
    base.write_text(json.dumps(data))
    child = tmp_path / "child.json"
    child.write_text(json.dumps({"@extend:": "base.json", "window_s": 8}))
    return child


@pytest.mark.parametrize("which", ["base", "web", "every_field"])
def test_conf_parse_matches_the_jax_package(which, tmp_path):
    path = (_every_field(tmp_path) if which == "every_field"
            else ROOT / "conf" / f"{which}.json.sample")
    want = dataclasses.asdict(jax_conf.parse(str(path)))
    got = dataclasses.asdict(port_conf.parse(str(path)))
    assert got == want
    if which == "every_field":
        assert got["window_s"] == 8 and got["prefix"] == "/other"
        assert got["mail"]["keepalive"] == 30
        assert got["checkpoint_dir"] == str(tmp_path / "ckpt")


def test_entry_matches_the_jax_entry():
    fn, args = __graft_entry__.entry()
    want = [np.asarray(a) for a in jax.jit(fn)(*args)]
    tfn, targs = port_entry.entry(device="cpu")
    got = [t.numpy() for t in tfn(*targs)]
    idx, total, assigned = got[0]
    assert total[0] > 0 and (assigned >= 0).any()
    for name, w, g in zip(("idx/total/assigned", "load", "rem_cap"),
                          want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
