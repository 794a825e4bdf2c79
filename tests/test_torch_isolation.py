"""The port stands alone: it loads no JAX, imports nothing of cronsun_tpu,
and never quietly runs on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cronsun_tpu_torch.device import resolve_device
from cronsun_tpu_torch.ops.planner import TickPlanner

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cronsun_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "cronsun_tpu"}


def test_import_loads_no_jax():
    code = ("import sys, cronsun_tpu_torch, cronsun_tpu_torch.convert, "
            "cronsun_tpu_torch.synth, cronsun_tpu_torch.ops.planner, "
            "cronsun_tpu_torch.ops.tick, cronsun_tpu_torch.cron, "
            "cronsun_tpu_torch.log, cronsun_tpu_torch.core, "
            "cronsun_tpu_torch.metrics, cronsun_tpu_torch.trace, "
            "cronsun_tpu_torch.checkpoint, cronsun_tpu_torch.store, "
            "cronsun_tpu_torch.store.sharded, cronsun_tpu_torch.sched, "
            "cronsun_tpu_torch.sched.partition, "
            "cronsun_tpu_torch.sched.publisher, "
            "cronsun_tpu_torch.bin.sched, cronsun_tpu_torch.bin.common, "
            "cronsun_tpu_torch.profile_server, "
            "cronsun_tpu_torch.conf, cronsun_tpu_torch.health, "
            "cronsun_tpu_torch.events, cronsun_tpu_torch.tlsutil, "
            "cronsun_tpu_torch.store.remote, cronsun_tpu_torch.store.wire, "
            "cronsun_tpu_torch.repl, cronsun_tpu_torch.repl.client, "
            "cronsun_tpu_torch.core.breaker, cronsun_tpu_torch.chaos, "
            "cronsun_tpu_torch.chaos.hooks, cronsun_tpu_torch.entry, "
            "cronsun_tpu_torch.parallel, cronsun_tpu_torch.parallel.mesh, "
            "cronsun_tpu_torch.parallel.hostsync, "
            "cronsun_tpu_torch.parallel.collectives, "
            "cronsun_tpu_torch.store.native, cronsun_tpu_torch.scripts, "
            "cronsun_tpu_torch.scripts.bench_sched, "
            "cronsun_tpu_torch.scripts.bench_mesh, "
            "cronsun_tpu_torch.chaos.faultproxy, "
            "cronsun_tpu_torch.chaos.invariants, cronsun_tpu_torch.logsink, "
            "cronsun_tpu_torch.logsink.joblog, "
            "cronsun_tpu_torch.logsink.tiering, "
            "cronsun_tpu_torch.logsink.traces, "
            "cronsun_tpu_torch.logsink.serve, "
            "cronsun_tpu_torch.logsink.native, cronsun_tpu_torch.node, "
            "cronsun_tpu_torch.node.executor, cronsun_tpu_torch.node.agent, "
            "cronsun_tpu_torch.repl.log, cronsun_tpu_torch.repl.manager, "
            "cronsun_tpu_torch.scripts.bench_chaos, "
            "cronsun_tpu_torch.logsink.sharded, cronsun_tpu_torch.noticer, "
            "cronsun_tpu_torch.web, cronsun_tpu_torch.web.server, "
            "cronsun_tpu_torch.web.push, cronsun_tpu_torch.web.sse_epoll, "
            "cronsun_tpu_torch.web.slo, cronsun_tpu_torch.web.ui, "
            "cronsun_tpu_torch.web.cache, cronsun_tpu_torch.web.sessions, "
            "cronsun_tpu_torch.bin.store, cronsun_tpu_torch.bin.logd, "
            "cronsun_tpu_torch.bin.node, cronsun_tpu_torch.bin.web, "
            "cronsun_tpu_torch.bin.ctl, cronsun_tpu_torch.demo, "
            "cronsun_tpu_torch.scripts.bench_store, "
            "cronsun_tpu_torch.scripts.bench_dispatch, "
            "cronsun_tpu_torch.scripts.bench_query, "
            "cronsun_tpu_torch.scripts.bench_push, "
            "cronsun_tpu_torch.scripts.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cronsun_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


HOST_MODULES = ("cronsun_tpu_torch.bin.ctl", "cronsun_tpu_torch.bin.store",
                "cronsun_tpu_torch.bin.logd", "cronsun_tpu_torch.bin.node",
                "cronsun_tpu_torch.bin.web",
                "cronsun_tpu_torch.scripts.bench_store",
                "cronsun_tpu_torch.scripts.bench_dispatch",
                "cronsun_tpu_torch.scripts.bench_query",
                "cronsun_tpu_torch.scripts.bench_push")


@pytest.mark.parametrize("mod", HOST_MODULES)
def test_a_host_process_module_loads_no_torch(mod):
    """The processes that do no device work (the CLI, the store, result
    store, agent and web launchers, the host benches and their children)
    start without torch; ``cronsun_tpu_torch.resolve_device`` still
    resolves, lazily."""
    code = (f"import sys, {mod}; assert 'torch' not in sys.modules; "
            "import cronsun_tpu_torch as p; "
            "assert p.resolve_device('cpu').type == 'cpu'")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_port_file_imports_jax_or_the_jax_package(path):
    assert path.exists(), path
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_no_device_on_a_cpu_only_host_raises(monkeypatch):
    from cronsun_tpu_torch.sched import SchedulerService
    from cronsun_tpu_torch.store import MemStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TickPlanner(64, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerService(MemStore(), job_capacity=64, node_capacity=32)
    from cronsun_tpu_torch.entry import dryrun_multichip, entry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)
    from cronsun_tpu_torch.parallel import make_mesh, make_mesh2d
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh2d(2, 2)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
