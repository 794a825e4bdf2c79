"""The port's mesh bench against the JAX script's, on the CPU.

One rung config goes to ``scripts/bench_mesh.py``'s worker (the JAX mesh on
the forced host devices of ``tests/conftest.py``) and to
``cronsun_tpu_torch.scripts.bench_mesh.run_worker`` (every shard on the
CPU).  The records must have the same key names (the port adds
``shards_per_device``) and be equal on every key that counts fires or bytes,
the demand format picked and the fire-set divergence.  Also: the port's
``synth_table`` equals ``bench.synth_table`` column for column, and the
multi-process (gloo) rung over 2 processes equals one process with 2
shards.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cronsun_tpu_torch.ops.schedule_table import DTYPES, table_to_numpy
from cronsun_tpu_torch.scripts import bench_mesh as port_mesh
from cronsun_tpu_torch.synth import synth_table
from torch_parity import one_torch_thread, time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_mesh as jax_mesh  # noqa: E402

# the keys that must be equal: what fired, the byte model, the bucket and
# format, and the divergence; and measured_bytes_per_tick on the sharded
# path.  On the replicated path the JAX worker's measured bytes are those of
# the collectives XLA compiled (39936 at 1-D D = 2, 4096 x 256 against its
# model's 56320: the compiler merges the candidate gathers); the port
# counts what its collectives move, which is the model's number.
RECORD_KEYS = (
    "devices", "mesh", "path", "jobs", "nodes", "k_local", "ticks",
    "fired_per_tick", "collective_bytes_per_round",
    "collective_bytes_per_tick", "replicated_bytes_per_round",
    "sharded_bytes_per_round", "compacted_bytes_per_round",
    "demand_format", "demand_format_requested", "predicted_bytes_per_tick")
PORT_ONLY = {"shards_per_device"}


def rung(mesh, path, D, J=4096, N=256, **kw):
    cfg = dict(devices=D, mesh=mesh, dj=D // 2 if mesh == "2d" else D,
               dn=2 if mesh == "2d" else 1, J=J, N=N, path=path,
               bucket=max(2048, J // 4), ticks=3, window=2, win_reps=1,
               quick=True, demand_format="auto",
               check_divergence=path == "sharded", period_lo=4,
               period_hi=12)
    cfg.update(kw)
    return cfg


def jax_record(cfg, capsys):
    capsys.readouterr()
    jax_mesh.run_worker(cfg)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_records_equal(ref, got):
    assert set(got) - PORT_ONLY == set(ref), set(got) ^ set(ref)
    keys = RECORD_KEYS + ("fire_fraction", "fire_set_divergence")
    if got["path"] == "sharded":
        keys += ("measured_bytes_per_tick",)
    for k in keys:
        assert got.get(k) == ref.get(k), (k, ref.get(k), got.get(k))
    assert got["measured_bytes_per_tick"] == got["predicted_bytes_per_tick"]


@pytest.mark.parametrize("cfg", [
    rung("1d", "sharded", 2), rung("1d", "replicated", 2),
    rung("2d", "sharded", 4), rung("2d", "replicated", 4),
    # a sparse rung: 1% of the rows fire on a wide fleet (compacted
    # demand); every period 100 (periods are drawn from [lo, hi))
    rung("1d", "sharded", 2, N=4096, bucket=2048, fire_fraction=0.01,
         period_lo=100, period_hi=101, window=1),
], ids=["1d_D2_sharded", "1d_D2_replicated", "2d_2x2_sharded",
        "2d_2x2_replicated", "sparse_D2_f0.01"])
def test_rung_matches_the_jax_worker(cfg, capsys, forced_host_devices):
    with time_limit(120, "bench_mesh rung"):
        ref = jax_record(cfg, capsys)
        got = port_mesh.run_worker(cfg, device="cpu")
    assert_records_equal(ref, got)
    assert got["shards_per_device"] == cfg["devices"]
    assert got["fired_per_tick"] > 0
    if cfg.get("check_divergence"):
        assert got["fire_set_divergence"] == 0
    if cfg.get("fire_fraction"):
        assert got["demand_format"] == "compacted"


@pytest.mark.parametrize("J,lo,hi,seed", [
    (4096, 4, 12, 0), (1000, 100, 101, 3), (65536, 35, 70, 1)])
def test_synth_table_matches_bench(J, lo, hi, seed):
    ref = bench.synth_table(J, lo, hi, seed=seed)
    got = table_to_numpy(synth_table(J, lo, hi, seed=seed, device="cpu"))
    for k, dt in DTYPES.items():
        want = np.asarray(getattr(ref, k))
        assert want.dtype == dt, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rung_matches_one_process():
    """The multi-process rung (gloo) over 2 processes, one shard each,
    against one process holding both shards."""
    cfg = rung("1d", "sharded", 2, J=4096, N=128, ticks=2, window=1)
    base = [sys.executable, "-m", "cronsun_tpu_torch.scripts.bench_mesh",
            "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        base + ["--worker", json.dumps(dict(cfg, dcn=True)),
                "--mesh-hosts", "2", "--mesh-proc-id", str(r),
                "--mesh-coordinator", coord],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        one = subprocess.run(base + ["--worker", json.dumps(cfg)], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert one.returncode == 0, one.stderr
    ref = json.loads(one.stdout.strip().splitlines()[-1])
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        got = json.loads(out.strip().splitlines()[-1])
        assert got["dcn_processes"] == 2
        assert got["shards_per_device"] == 1
        for k in RECORD_KEYS + ("measured_bytes_per_tick",
                                "fire_set_divergence"):
            assert got[k] == ref[k], (k, ref[k], got[k])
    assert ref["shards_per_device"] == 2
    assert ref["fire_set_divergence"] == 0


def test_no_card_error_and_multiprocess_flags(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mesh.main(["--quick"])
    with pytest.raises(SystemExit):
        port_mesh.main(["--quick", "--device", "cpu", "--mesh-hosts", "2"])
