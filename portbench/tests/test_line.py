"""The result line's keys and order, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_the_line_has_the_contract_keys_with_checks_last(tiny):
    line, checks, _info = harness.run_cell("headline_common", 3, 0.5, False,
                                           device="cpu", pkg=tiny)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert [n for n, _v, _l in checks] == list(line["checks"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_a_traced_line_has_busy_window_and_breakdown(tiny):
    line, _c, _i = harness.run_cell("headline_steady", 4, 0.5, True,
                                    device="cpu", pkg=tiny)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # per-layer metrics only; on the CPU no device metric has anything to
    # read, the host range does
    assert set(line["metrics"]) == {"dispatch_host_ms"}


def _command(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "portbench", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_the_command_prints_no_result():
    r = _command(ROOT, "--workload", "headline_steady", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_an_unknown_cell_is_refused():
    r = _command(ROOT, "--workload", "nope", "--seed", "1", "--seconds", "1",
                 "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path, "--workload", "headline_steady", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""
    # past the card check, the program is not there to import
    r = subprocess.run(
        [sys.executable, "-c", "from portbench import harness; "
         "harness.run_cell('headline_steady', 1, 0.1, False, device='cpu')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0 and r.stdout == ""
    assert "cronsun_tpu_torch" in r.stderr
