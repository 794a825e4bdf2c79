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
            "cronsun_tpu_torch.ops.tick, cronsun_tpu_torch.cron; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cronsun_tpu')]; "
            "assert not bad, bad")
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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TickPlanner(64, 64)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
