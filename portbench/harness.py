"""Runs one cell of ``BENCHMARK.json`` once and assembles its result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name:

- ``portbench/configs/<config>.json`` — a deployment: its ``runner``,
  sizes, limits;
- ``portbench/<runner>_cell.py`` — a runner: ``run(spec, seed, seconds,
  trace, device, t0)`` returns the context the readers read, with its
  ``check()``;
- ``portbench/traffic/<traffic>.json`` — a mix, read by :mod:`.gen`;
- ``portbench/metrics/<metric>.py`` — a reader: ``read(ctx)`` returns the
  metric's value from what the run recorded, or None when it finds
  nothing to read (the line then leaves the metric out).  A metric
  ``<name>.<part>`` with no file of its own is read by ``<name>.py``: one
  quantity split by the end-to-end metric it moves.

So a cell, a runner, a mix or a metric is added by adding files and
entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cronsun_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, root: str = ROOT, pkg: str = HERE):
    """The cell ``name`` with its configuration, traffic and metrics."""
    b = bench(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    e2e = [m for m in b["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"] if _applies(m, name)
             and ("workloads" in m or m["moves"] in moved)]
    return SimpleNamespace(
        name=name, cell=cell,
        config=load_json(os.path.join(pkg, "configs", cell["config"] + ".json")),
        traffic=load_json(os.path.join(pkg, "traffic",
                                       cell["traffic"] + ".json")),
        end_to_end=e2e, per_layer=layer, pkg=pkg)


def _load(mod_name: str, path: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, pkg: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``, or of
    ``metrics/<base>.py`` for a ``<base>.<part>`` with no file of its
    own."""
    path = os.path.join(pkg, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(pkg, "metrics", name.rsplit(".", 1)[0] + ".py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    return _load(mod_name, path).read


def runner(name: str, pkg: str = HERE):
    """The runner module ``<name>_cell.py``: the package's own, or one that
    ``pkg`` adds beside its configurations (loaded as a module of this
    package, so that it may import the package's modules)."""
    path = os.path.join(pkg, name + "_cell.py")
    if pkg == HERE or not os.path.exists(path):
        return importlib.import_module(f"portbench.{name}_cell")
    return _load(f"portbench.{name}_cell", path)


def read_metrics(metrics: List[dict], ctx, pkg: str = HERE) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"], pkg)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.partition(".")[0] in FORBIDDEN})


def device_info(dev: torch.device, ctx) -> dict:
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind, "count": 1,
            "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s()
        info["window_s"] = ctx.trace.window_s()
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, root: str = ROOT,
             pkg: str = HERE):
    """One run of a cell.  Returns (result line dict, checks, info): the
    checks are ``(name, value, limit)``, compared once the program's state
    is freed."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(name, root, pkg)
    dev = torch.device(device)
    ctx = runner(spec.config["runner"], pkg).run(spec, seed, seconds,
                                                 trace, dev, t0)
    ctx.device_kind = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")
    ctx.config, ctx.traffic = spec.config, spec.traffic
    metrics = read_metrics(spec.per_layer if trace else spec.end_to_end, ctx,
                           pkg)
    dev_info = device_info(dev, ctx)
    checks, attempted, failed, info = ctx.check()
    line = {"correct": all(v <= lim for _n, v, lim in checks),
            "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": dev_info}
    if ctx.trace is not None:
        line["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                             "idle_gaps": ctx.trace.idle_gaps()}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line, checks, info
