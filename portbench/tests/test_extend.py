"""A configuration, a runner, a mix and a metric are added by new files and
new entries: a throwaway cell on a throwaway runner runs and reports its
new metrics, and no file of the package changes."""

import hashlib
import json
import os
import shutil

from portbench import harness


def _digest(d):
    h = {}
    for base, _dirs, files in os.walk(d):
        if "__pycache__" in base:
            continue
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                h[os.path.relpath(os.path.join(base, f), d)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return h


def test_a_new_cell_and_metric_need_only_new_files(tiny, tmp_path):
    before = _digest(harness.HERE)
    pkg = tmp_path / "portbench"
    shutil.copytree(tiny, pkg)
    root = tmp_path
    b = harness.bench()
    cfg = json.loads((pkg / "configs" / "headline_1m_x_10k.json").read_text())
    cfg.update(jobs=2048, nodes=128, runner="toy")
    (pkg / "configs" / "tiny_extra.json").write_text(json.dumps(cfg))
    (pkg / "toy_cell.py").write_text(
        "from . import planner_cell\n\n\n"
        "def run(spec, seed, seconds, trace, device, t0):\n"
        "    ctx = planner_cell.run(spec, seed, seconds, trace, device, t0)\n"
        "    ctx.toy_windows = ctx.windows\n"
        "    return ctx\n")
    (pkg / "metrics" / "toy_windows.py").write_text(
        "def read(ctx):\n    return getattr(ctx, 'toy_windows', None)\n")
    (pkg / "traffic" / "every_fast.json").write_text(json.dumps({
        "exclusive_share": 0.25,
        "families": [{"share": 0.9, "every_s": [5, 9]},
                     {"share": 0.1, "cron": "*/3 * * * * *"}],
        "sla_bucket": [512, 1024], "start_epoch": 1753000000}))
    (pkg / "metrics" / "traced_seconds.py").write_text(
        "def read(ctx):\n    return getattr(ctx, 'traced_seconds', None)\n")
    b["configs"].append({"name": "tiny_extra", "source": "a test",
                         "file": "portbench/configs/tiny_extra.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "extra_cell", "config": "tiny_extra",
                           "traffic": "every_fast", "chips": 1, "why": "t"})
    for m in b["end_to_end"]:
        if "workloads" in m and "headline_steady" in m["workloads"]:
            m["workloads"].append("extra_cell")
    b["per_layer"].append({"name": "traced_seconds", "unit": "s",
                           "better": "higher", "source": "program_counter",
                           "layer": "ops.planner", "moves": "tick_ms_p99",
                           "workloads": ["extra_cell"]})
    b["per_layer"].append({"name": "toy_windows", "unit": "windows",
                           "better": "higher", "source": "program_counter",
                           "layer": "ops.planner", "moves": "tick_ms_p99",
                           "workloads": ["extra_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    line, _c, _i = harness.run_cell("extra_cell", 8, 0.5, False,
                                    device="cpu", root=str(root), pkg=str(pkg))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"tick_ms_p99", "plan_fires_per_s",
                                    "setup_s"}
    line, _c, _i = harness.run_cell("extra_cell", 8, 0.5, True,
                                    device="cpu", root=str(root), pkg=str(pkg))
    assert line["correct"], line["checks"]
    assert line["metrics"]["traced_seconds"]["value"] > 0
    assert line["metrics"]["toy_windows"]["value"] > 0      # the new runner
    assert _digest(harness.HERE) == before
